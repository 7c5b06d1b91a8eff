// K8 ct_ba_block: a CT-BA step's block-Jacobi inner iterations (every
// keyframe's damped 12x12 Gauss-Newton update, `iters` times), or the point
// + prior blocks the coupled (PCG) step assembles, in one launch.
//
// Replaces ct_icp_tpu/parallel/ct_ba.py:120-152 (_frame_gn_update, vmapped
// over the keyframes by local_step's fori_loop, :228-278) and :170-198
// (_frame_blocks, local_step_pcg's row pass). The reference forms each
// keyframe's normal equations by jax.jacfwd over K point rows, 8 continuity
// rows and 8 prior rows; here the rows carry 12 forward-mode tangents as
// dual numbers (dual.cuh's formulas, so each tangent follows jax.jacfwd's
// arithmetic: quat_slerp's sign flip, clip and nlerp fallback included; the
// duals divide by one reciprocal, RDualT below).
//
// Grid: a thread-block cluster of C CTAs a keyframe (C = 16 or 8, the
// largest whose F clusters are all resident at once; the wrapper asks the
// occupancy API and picks), 544 threads a CTA: 16 row warps and one pose
// warp. Each CTA owns a contiguous slice of its frame's K rows and brings
// it into shared memory once a launch (44 B a row); every iteration reuses
// it. An iteration:
//   1. the row warps, two threads a row (the begin and the end half of the
//      tangents: the two Dual6 passes of a row are independent), evaluate
//      the residual and its 12 tangents of 256 rows a pass into a chunk;
//      455 threads sum the chunk's 91 products (78 of J^T J, 12 of J^T r,
//      r^2) over five row groups, each group in row order, and add the
//      groups in order into the CTA's partial sums;
//   2. meanwhile 24 lanes of rank 0's pose warp build the 16 pose-level
//      rows (a lane a column and row group, one tangent each): the
//      continuity rows against the neighbours' previous iterate, the prior
//      rows against the assembly-time pose. A neighbour's iterate is read
//      from global memory once its frame's iteration flag says it is there
//      (release by the writer, acquire here); the window's ends meet a zero
//      weight and need no neighbour. The warp builds them right after the
//      previous iteration's solve, between the two halves (arrive, wait)
//      of the cluster barrier that starts the next one;
//   3. a cluster barrier; rank 0 sums the CTAs' partials through
//      distributed shared memory in rank order, adds the pose rows, scales
//      the damped system (78 threads) and solves it by one thread's
//      Cholesky (mode 0, "gn"), writes the new pose (to a double buffer in
//      global memory for the neighbours, with its flag, or to poses_out
//      after the last iteration), and computes the new pose's tangents
//      once for the cluster; a second cluster barrier, and the other CTAs
//      copy them.
// Frame f's iteration i waits only for frames f - 1 and f + 1 to finish
// iteration i - 1. The last cluster to finish (an integer counter) sums the
// frames' costs in frame order into the total and leaves the flags and the
// counter zero. No float atomics, fixed summation orders: a launch repeats
// bit for bit, and `iters` iterations in one launch equal `iters` launches
// of one.
// A single-iteration "gn" launch may take a halo (the sharded window of
// parallel/ct_ba.py: this rank's frames are a slice of the window): f32
// [2, 16], row 0 the neighbour before the first frame (its iterate, 14
// floats, its edge_alpha, then 1 or 0: whether that edge exists), row 1 the
// neighbour after the last frame (its iterate, unused, 1 or 0). Those two
// neighbours are read from it, in place of the window's ends; every other
// frame reads its neighbours from the window as before. The neighbour's
// pose is extrapolated here, by the same pose_at as a neighbour inside the
// window, so a rank's launch gives the one-device launch's rows bit for
// bit.
// Mode 1 ("blocks", one iteration) leaves the continuity rows out (the
// coupled solver's edges stay in torch) and solves nothing. A row of
// weight 0 is skipped: the reference's row is exactly 0 there (0 times a
// finite residual).
//
// Bound: bytes (44 B a row read once, the poses, priors and outputs), or
// operations (850-1,000 float operations a row an iteration: the residual,
// 12 tangents and the 91 products and sums), whichever is longer: ~0.4-0.5
// us an iteration for F = 8, K = 4,096. The launch is bound by its serial
// chain an iteration: the row pass (one dual-number row a thread), the
// sums, a cluster barrier, the rank-order sum, the solve, the new pose's
// tangents and a second barrier.
//
// Measurement variants (tools/exp_ct_ba.py, chip_smoke.py; the main path
// never builds them): -DK8_MARKS adds thread 0's clock cycles in each
// phase, for ranks 0 and 1 of frame 0, to a device array that
// k8_read_marks returns; -DK8_IEEE_DUAL takes dual.cuh's duals (an IEEE
// division for every part of a dual division).
#include <cooperative_groups.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "dual.cuh"

namespace cg = cooperative_groups;

namespace cticp {

// K8's dual numbers: DualT's rules (dual.cuh, which K5 keeps), except that
// a division takes one IEEE division, the reciprocal of the divisor's
// value, and multiplies the value and every tangent by it (DualT divides
// each of the N + 1 parts), and a square root's tangents are multiplied by
// one half-reciprocal. Each result moves off DualT's by a rounding or two:
// within the tolerance that holds K8 to its plain version, not bit for
// bit. The serial chains of the row pass, the tangents and the pose rows
// are mostly these divisions.
template <int N>
struct RDualT {
  float v;
  float d[N];
  RDualT() = default;
  __device__ __forceinline__ RDualT(float value) : v(value) {
#pragma unroll
    for (int j = 0; j < N; ++j) d[j] = 0.0f;
  }
};

#define RDUAL_OP(expr_v, expr_d)                  \
  RDualT<N> r(expr_v);                            \
  _Pragma("unroll") for (int j = 0; j < N; ++j) r.d[j] = (expr_d); \
  return r;

template <int N>
__device__ __forceinline__ RDualT<N> operator+(const RDualT<N>& a,
                                               const RDualT<N>& b) {
  RDUAL_OP(a.v + b.v, a.d[j] + b.d[j])
}
template <int N>
__device__ __forceinline__ RDualT<N> operator-(const RDualT<N>& a,
                                               const RDualT<N>& b) {
  RDUAL_OP(a.v - b.v, a.d[j] - b.d[j])
}
template <int N>
__device__ __forceinline__ RDualT<N> operator-(const RDualT<N>& a) {
  RDUAL_OP(-a.v, -a.d[j])
}
template <int N>
__device__ __forceinline__ RDualT<N> operator*(const RDualT<N>& a,
                                               const RDualT<N>& b) {
  RDUAL_OP(a.v * b.v, a.d[j] * b.v + a.v * b.d[j])
}
template <int N>
__device__ __forceinline__ RDualT<N> operator/(const RDualT<N>& a,
                                               const RDualT<N>& b) {
  const float inv = 1.0f / b.v;
  const float q = a.v * inv;
  RDUAL_OP(q, (a.d[j] - q * b.d[j]) * inv)
}
template <int N>
__device__ __forceinline__ RDualT<N> operator-(const RDualT<N>& a, float b) {
  RDUAL_OP(a.v - b, a.d[j])
}
template <int N>
__device__ __forceinline__ RDualT<N> operator-(float a, const RDualT<N>& b) {
  RDUAL_OP(a - b.v, -b.d[j])
}
template <int N>
__device__ __forceinline__ RDualT<N> operator*(float a, const RDualT<N>& b) {
  RDUAL_OP(a * b.v, a * b.d[j])
}
template <int N>
__device__ __forceinline__ RDualT<N> operator*(const RDualT<N>& a, float b) {
  RDUAL_OP(a.v * b, a.d[j] * b)
}
template <int N>
__device__ __forceinline__ RDualT<N> operator/(const RDualT<N>& a, float b) {
  const float inv = 1.0f / b;
  RDUAL_OP(a.v * inv, a.d[j] * inv)
}
template <int N>
__device__ __forceinline__ float val(const RDualT<N>& x) {
  return x.v;
}
template <int N>
__device__ __forceinline__ RDualT<N> tsqrt(const RDualT<N>& x) {
  const float s = sqrtf(x.v);
  const float h = 0.5f / s;
  RDUAL_OP(s, x.d[j] * h)
}
template <int N>
__device__ __forceinline__ RDualT<N> tsin(const RDualT<N>& x) {
  const float c = cosf(x.v);
  RDUAL_OP(sinf(x.v), c * x.d[j])
}
template <int N>
__device__ __forceinline__ RDualT<N> tcos(const RDualT<N>& x) {
  const float s = -sinf(x.v);
  RDUAL_OP(cosf(x.v), s * x.d[j])
}
template <int N>
__device__ __forceinline__ RDualT<N> tacos(const RDualT<N>& x) {
  const float m = -1.0f / sqrtf(1.0f - x.v * x.v);
  RDUAL_OP(acosf(x.v), x.d[j] * m)
}
template <int N>
__device__ __forceinline__ RDualT<N> tabs(const RDualT<N>& x) {
  return x.v < 0.0f ? -x : x;
}
#undef RDUAL_OP

}  // namespace cticp

namespace {

using namespace cticp;

// the duals of the row pass (6 tangents) and of the pose-level work (1)
#ifdef K8_IEEE_DUAL
template <int N>
using KDual = DualT<N>;        // measurement variant: dual.cuh's divisions
#else
template <int N>
using KDual = RDualT<N>;
#endif
using KDual1 = KDual<1>;
using KDual6 = KDual<kTan>;
static_assert(sizeof(Pose<KDual6>) == sizeof(Pose<Dual6>) &&
                  sizeof(Slerp<KDual6>) == sizeof(Slerp<Dual6>) &&
                  offsetof(Slerp<KDual6>, near) == 10 * sizeof(KDual6),
              "scatter_tangent's layout");

constexpr int kRowThreads = 512;            // two a row
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kThreads = kRowThreads + 32;  // + the pose warp
constexpr int kRowsPass = kRowThreads / 2;  // rows a pass
constexpr int kSums = 91;                   // 78 J^T J, 12 J^T r, 1 r^2
constexpr int kGroups = 5;                  // row groups of a pass's sums
constexpr int kChunkStride = 13;            // jac 12, r (odd: no conflicts)
constexpr int kPoseRows = 16;               // 8 continuity, 8 prior
constexpr int kMaxCluster = 16;
constexpr int kRowsOnChip = 4096;           // rows a CTA keeps on chip
constexpr int kRowFloats = 11;              // raw 3, alpha, anchor 3,
                                            // normal 3, weight
constexpr int kRowBarrier = 1;              // named barrier of the row warps

#ifdef K8_MARKS
// the phases of thread 0 (slot 0: rank 0 of frame 0, slot 1: rank 1) and of
// rank 0's pose warp: 0 rows into shared memory + the first tangents,
// 1 barrier A + the tangent copy, 2 row pass, 3 CTA sums, 4 barrier B,
// 5 cluster sums, 6 J^T J assembly, 7 solve + new pose + flag, 8 the new
// pose's tangents, 9 the pose warp's wait for the neighbours, 10 its pose
// rows, 11 the last-cluster count and the total; 12 calls, 13 globaltimer
// ns and 14 clock cycles of the CTA's span
constexpr int kMarks = 15;
__device__ long long g_marks[2][kMarks];
__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define MARK(k)                        \
  if (timed) {                         \
    const long long t_now = clock64(); \
    ph[k] += t_now - t_mark;           \
    t_mark = t_now;                    \
  }
#else
#define MARK(k)
#endif

// The tangents of a pose, which every row pass reads: what rank 0
// computes once an iteration and the other CTAs copy.
struct Tangents {
  Pose<KDual6> pose_d[2];   // the pose's begin / end tangents
  Slerp<KDual6> slerp_d[2];
};
static_assert(sizeof(Tangents) % 4 == 0, "copied as 32-bit words");
constexpr int kTanWords = static_cast<int>(sizeof(Tangents) / 4);
static_assert(kTanWords <= kThreads, "a thread a word");

struct Shared {
  Tangents tan;
  float part[kSums + 1];             // this CTA's sums (read by rank 0)
  float grp[kGroups][kSums + 1];     // a pass's sums by row group
  float sums[kSums + 1];             // the cluster's (rank 0)
  float jtj[144];
  float jtr[12];
  float pj[kPoseRows][12];           // the pose-level rows' Jacobian
  float pr[kPoseRows];               // and their residuals
  float pose[16];                    // the current iterate (rank 0)
  float dsc[12];                     // the solve's Jacobi scaling
  float chol[78];                    // its system, packed lower triangle
  float rhs[12];                     // its right-hand side, then solution
  float cost;
  unsigned char pair[kSums][2];      // (a, c) of each sum; 12 = r
  int last;
};
constexpr int kSharedBytes = (static_cast<int>(sizeof(Shared)) + 15) / 16 * 16;
constexpr int kChunkBytes = kRowsPass * kChunkStride * 4;

template <class T>
__device__ __forceinline__ T quat_dot(const Quat<T>& q, const float* p) {
  return ((q.w * p[0] + q.x * p[1]) + q.y * p[2]) + q.z * p[3];
}

// _pose_at: the pose at interpolation parameter alpha (slerp of the
// normalised quaternions, lerp of the translations; alpha > 1
// extrapolates)
template <class T>
__device__ __forceinline__ void pose_at(const Pose<T>& p, float alpha,
                                        Quat<T>& q, Vec3<T>& t) {
  const Slerp<T> s = slerp_setup(quat_normalize(p.qb), quat_normalize(p.qe));
  q = slerp_at(s, alpha);
  const float b = 1.0f - alpha;
  t = {b * p.tb.x + alpha * p.te.x, b * p.tb.y + alpha * p.te.y,
       b * p.tb.z + alpha * p.te.z};
}

// Frame f's pose-level rows at its perturbed pose p, in two groups of
// lanes: rows 4-7 (continuity toward the successor: the pose extrapolated
// to its begin timestamp against its begin pose (qn, tn)), and rows 0-3
// (continuity from the predecessor's extrapolation (qp, tp)) with the
// prior rows 8-15 (against the assembly-time pose pair); zero weights at
// the window's ends.
template <class T>
__device__ __forceinline__ void next_rows(const Pose<T>& p, const float* qn,
                                          const float* tn, float w_next,
                                          float beta, float ea, T* r) {
  const float bn = beta * w_next;
  Quat<T> qx;
  Vec3<T> tx;
  pose_at(p, ea, qx, tx);
  r[0] = bn * (tx.x - tn[0]);
  r[1] = bn * (tx.y - tn[1]);
  r[2] = bn * (tx.z - tn[2]);
  const T dn = quat_dot(quat_normalize(qx), qn);
  r[3] = bn * (1.0f - dn * dn);
}

template <class T>
__device__ __forceinline__ void prev_prior_rows(
    const Pose<T>& p, const float* qp, const float* tp, float w_prev,
    float beta, const float* pqb, const float* ptb, const float* pqe,
    const float* pte, float pw, T* r) {
  const float bp = beta * w_prev;
  r[0] = bp * (p.tb.x - tp[0]);
  r[1] = bp * (p.tb.y - tp[1]);
  r[2] = bp * (p.tb.z - tp[2]);
  const T dp = quat_dot(quat_normalize(p.qb), qp);
  r[3] = bp * (1.0f - dp * dp);
  r[4] = pw * (p.tb.x - ptb[0]);
  r[5] = pw * (p.tb.y - ptb[1]);
  r[6] = pw * (p.tb.z - ptb[2]);
  const T db = quat_dot(quat_normalize(p.qb), pqb);
  r[7] = pw * (1.0f - db * db);
  r[8] = pw * (p.te.x - pte[0]);
  r[9] = pw * (p.te.y - pte[1]);
  r[10] = pw * (p.te.z - pte[2]);
  const T de = quat_dot(quat_normalize(p.qe), pqe);
  r[11] = pw * (1.0f - de * de);
}

// Lane j < 12 of a warp: column j of the pose's tangents and of its slerp
// setup, scattered into `tan`.
__device__ __forceinline__ Pose<KDual1> seeded_pose(const float* pose,
                                                    int j) {
  KDual1 d[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    d[c] = KDual1{0.0f};
    if (c == j) d[c].d[0] = 1.0f;
  }
  return apply_delta(d, pose_from<KDual1>(pose));
}

__device__ __forceinline__ void pose_tangents(const float* pose, int j,
                                              Tangents& tan) {
  const Pose<KDual1> pd = seeded_pose(pose, j);
  const Slerp<KDual1> sl = slerp_setup(pd.qb, pd.qe);
  scatter_tangent(pd, tan.pose_d[j / kTan], j % kTan, 14);
  scatter_tangent(sl, tan.slerp_d[j / kTan], j % kTan, 10);
  if (j % kTan == 0) tan.slerp_d[j / kTan].near = sl.near;
}

__device__ __forceinline__ void row_barrier() {
  asm volatile("bar.sync %0, %1;" ::"n"(kRowBarrier), "n"(kRowThreads)
               : "memory");
}

// The cluster barrier in its two halves, so that rank 0's pose warp can
// arrive, build the next iteration's pose rows, and only then wait. Whole
// warps call them, some right after a branch that only part of the warp
// took (the pose warp's lanes 24-31 build no pose rows; warp 2's lanes
// 91-95 sum nothing across the cluster): each half first reconverges the
// warp, then arrives or waits once for all its lanes (.aligned, as
// CUTLASS's cluster barriers do), so that no barrier is ever reached by
// part of a warp. Without .aligned, nvcc guards each barrier with a branch
// to a separate path for a warp that reaches it diverged.
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// The sum over the cluster's CTAs, in rank order, of the float at `local`
// in each CTA's shared memory: the remote loads issued together, then
// added in order.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* local, int ranks) {
  float v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    v[q] = q < ranks ? *cluster.map_shared_rank(local, q) : 0.0f;
  float s = v[0];
#pragma unroll
  for (int q = 1; q < kMaxCluster; ++q)
    if (q < ranks) s += v[q];
  return s;
}

struct Args {
  const float* poses_in;   // [F, 14] the first iterate
  float* poses_out;        // [F, 14] the last ("gn")
  float* iterates;         // [2, F, 14] the iterates in between
  const float* raw;        // [F, K, 3]
  const float* alphas;     // [F, K]
  const float* anchors;    // [F, K, 3]
  const float* normals;    // [F, K, 3]
  const float* weights;    // [F, K]
  const float* pqb;        // [F, 4] the prior pose pair
  const float* ptb;        // [F, 3]
  const float* pqe;        // [F, 4]
  const float* pte;        // [F, 3]
  const float* prior_weight;  // [F]
  const float* edge_alpha;    // [F]
  const float* halo;       // [2, 16] or null (single-iteration "gn" only)
  int* flags;              // [1 + F]: the finished clusters, then each
                           // frame's finished iterations; left zero
  float* cost;             // [F] the last iteration's
  float* total;            // [1] their sum in frame order
  float* jtj;              // [F, 144] the last iteration's
  float* jtr;              // [F, 12]
  int nf, k, rows_per_cta, on_chip, mode, iters;
  float beta, damping;
};

// Lane g * 12 + j (g 0 or 1, j < 12) of rank 0's pose warp: column j of
// frame f's pose-level rows of group g (0: rows 0-3 and 8-15, 1: rows 4-7)
// for iteration t, at the frame's iterate t - 1 (`own`) and its
// neighbours' (read once their flags reach t - 1; the window's ends meet a
// zero weight, where any finite pose gives the same rows, so the frame's
// own stands in and nothing is waited for). Returns the cycles waited.
__device__ __forceinline__ long long build_pose_rows(const Args& a,
                                                     Shared& sm,
                                                     const float* own, int f,
                                                     int t, int lane) {
  const long long t0 = clock64();
  const int grp = lane / 12, j = lane % 12;
  const bool gn = a.mode == 0;
  // the halo row of this group's neighbour, where it lies on another rank
  const float* hrow = nullptr;
  if (a.halo != nullptr && gn) {
    if (grp == 0 && f == 0) hrow = a.halo;
    if (grp == 1 && f == a.nf - 1) hrow = a.halo + 16;
  }
  const bool has = hrow != nullptr ? hrow[15] != 0.0f
                   : gn && (grp == 0 ? f > 0 : f < a.nf - 1);
  const int nb = grp == 0 ? f - 1 : f + 1;
  if (t > 1 && has && hrow == nullptr)
    while (load_acquire(a.flags + 1 + nb) < t - 1) __nanosleep(32);
  const long long waited = clock64() - t0;
  const float* it =
      t == 1 ? a.poses_in : a.iterates + ((t - 1) & 1) * a.nf * 14;
  float nbr[14];
#pragma unroll
  for (int v = 0; v < 14; ++v)
    nbr[v] = !has ? own[v] : hrow != nullptr ? hrow[v]
                                             : __ldcg(it + 14 * nb + v);
  const Pose<KDual1> pd = seeded_pose(own, j);
  if (grp == 0) {
    Quat<float> qp;
    Vec3<float> tp;
    const float ea = !has ? a.edge_alpha[f]
                     : hrow != nullptr ? hrow[14] : a.edge_alpha[nb];
    pose_at(pose_from<float>(nbr), ea, qp, tp);
    const float qpa[4] = {qp.w, qp.x, qp.y, qp.z};
    const float tpa[3] = {tp.x, tp.y, tp.z};
    KDual1 rr[12];
    prev_prior_rows(pd, qpa, tpa, has ? 1.0f : 0.0f, a.beta, a.pqb + 4 * f,
                    a.ptb + 3 * f, a.pqe + 4 * f, a.pte + 3 * f,
                    a.prior_weight[f], rr);
#pragma unroll
    for (int q = 0; q < 12; ++q) {
      const int row = q < 4 ? q : q + 4;
      sm.pj[row][j] = rr[q].d[0];
      if (j == 0) sm.pr[row] = rr[q].v;
    }
  } else {
    KDual1 rr[4];
    next_rows(pd, nbr, nbr + 4, has ? 1.0f : 0.0f, a.beta, a.edge_alpha[f],
              rr);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sm.pj[4 + q][j] = rr[q].d[0];
      if (j == 0) sm.pr[4 + q] = rr[q].v;
    }
  }
  return waited;
}

// The damped, Jacobi-scaled 12x12 system (symmetric positive definite: a
// scaled J^T J plus damping on the diagonal) on one thread: its lower
// triangle `a` (packed by rows, in shared memory) factored in place as
// L L^T, one square root and one reciprocal a column, then L y = b and
// L^T x = y; x into b. The factor stays in shared memory: held in
// registers it would be spilled (the CTA's 17 warps leave 96 a thread).
__device__ __forceinline__ void cholesky12(float* a, float* b) {
#define L(i, j) a[(i) * ((i) + 1) / 2 + (j)]
  float rinv[12], y[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const float r = 1.0f / sqrtf(L(k, k));
    rinv[k] = r;
    float col[12];
#pragma unroll
    for (int i = k + 1; i < 12; ++i) {
      col[i] = L(i, k) * r;
      L(i, k) = col[i];
    }
#pragma unroll
    for (int i = k + 1; i < 12; ++i)
#pragma unroll
      for (int j = k + 1; j <= i; ++j) L(i, j) = L(i, j) - col[i] * col[j];
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float s = b[i];
#pragma unroll
    for (int j = 0; j < i; ++j) s = s - L(i, j) * y[j];
    y[i] = s * rinv[i];
  }
#pragma unroll
  for (int i = 11; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int j = i + 1; j < 12; ++j) s = s - L(j, i) * y[j];
    y[i] = s * rinv[i];
  }
#undef L
#pragma unroll
  for (int q = 0; q < 12; ++q) b[q] = y[q];
}

__global__ void __launch_bounds__(kThreads, 1)
    ct_ba_block_kernel(const __grid_constant__ Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  extern __shared__ float4 dyn[];
  Shared& sm = *reinterpret_cast<Shared*>(dyn);
  float* chunk =
      reinterpret_cast<float*>(reinterpret_cast<char*>(dyn) + kSharedBytes);
  float* srows = chunk + kRowsPass * kChunkStride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = blockIdx.y, k = a.k;
  const bool gn = a.mode == 0;
  const bool pose_warp = warp == kRowWarps;
  const bool poser = pose_warp && rank == 0;   // builds the pose rows
#ifdef K8_MARKS
  const bool timed = f == 0 && rank < 2 && tid == 0;
  long long ph[kMarks] = {}, t_mark = timed ? clock64() : 0;
  const long long g0 = timed ? gtimer() : 0, c0 = t_mark;
  long long pw_wait = 0, pw_rows = 0;   // the pose warp's lane 0
#endif

  // ---- this CTA's rows, into shared memory once
  const int r0 = rank * a.rows_per_cta;
  const int nrows = max(0, min(a.rows_per_cta, k - r0));
  const size_t g = static_cast<size_t>(f) * k + r0;
  const float *raw = a.raw + 3 * g, *alp = a.alphas + g,
              *anc = a.anchors + 3 * g, *nrm = a.normals + 3 * g,
              *wgt = a.weights + g;
  if (a.on_chip) {
    // by the row warps, which alone read them
    float* s_raw = srows;
    float* s_alp = s_raw + 3 * nrows;
    float* s_anc = s_alp + nrows;
    float* s_nrm = s_anc + 3 * nrows;
    float* s_wgt = s_nrm + 3 * nrows;
    for (int v = pose_warp ? 3 * nrows : tid; v < 3 * nrows;
         v += kRowThreads) {
      s_raw[v] = raw[v];
      s_anc[v] = anc[v];
      s_nrm[v] = nrm[v];
    }
    for (int v = pose_warp ? nrows : tid; v < nrows; v += kRowThreads) {
      s_alp[v] = alp[v];
      s_wgt[v] = wgt[v];
    }
    raw = s_raw;
    alp = s_alp;
    anc = s_anc;
    nrm = s_nrm;
    wgt = s_wgt;
  }
  // the first iterate and its tangents, in every CTA; the sum pairs; the
  // first iteration's pose rows from the first iterate, at once
  if (poser && lane < 24) {
    const long long t0 = clock64();
    const long long w = build_pose_rows(a, sm, a.poses_in + 14 * f, f, 1,
                                        lane);
#ifdef K8_MARKS
    if (f == 0 && lane == 0) {
      pw_wait += w;
      pw_rows += clock64() - t0 - w;
    }
#else
    (void)t0;
    (void)w;
#endif
  }
  if (warp == 0 && lane < 12) pose_tangents(a.poses_in + 14 * f, lane, sm.tan);
  if (tid < 14) sm.pose[tid] = a.poses_in[14 * f + tid];
  if (tid < kSums) {
    int pa = 12, pc = 12;                 // 90: r * r
    if (tid < 78) {
      pa = 0;
      int s = tid;
      while (s >= 12 - pa) s -= 12 - pa++;
      pc = pa + s;
    } else if (tid < 90) {
      pa = tid - 78;
    }
    sm.pair[tid][0] = static_cast<unsigned char>(pa);
    sm.pair[tid][1] = static_cast<unsigned char>(pc);
  }
  if (!pose_warp) row_barrier();
  MARK(0);

  for (int it = 1; it <= a.iters; ++it) {
    // ---- A: rank 0's iterate and its tangents are out (rank 0's pose
    // warp arrived before building this iteration's pose rows)
    if (it > 1) {
      if (!poser) cluster_barrier();
      if (rank != 0 && tid < kTanWords)
        reinterpret_cast<float*>(&sm.tan)[tid] = cluster.map_shared_rank(
            reinterpret_cast<float*>(&sm.tan), 0)[tid];
      MARK(1);
    }
    if (poser) {
      if (it > 1) cluster_wait();
    } else if (!pose_warp) {
      // ---- the row warps: 256 rows a pass, then their sums
      row_barrier();   // the tangents copied
      for (int base = 0; base < max(nrows, 1); base += kRowsPass) {
        const int len = min(kRowsPass, nrows - base);
        const int i = base + (tid >> 1), h = tid & 1;
        if (i < nrows) {
          float jac[kTan], r = 0.0f;
#pragma unroll
          for (int j = 0; j < kTan; ++j) jac[j] = 0.0f;
          if (wgt[i] != 0.0f) {
            const float row[kRowFloats] = {
                raw[3 * i],     raw[3 * i + 1], raw[3 * i + 2], alp[i],
                anc[3 * i],     anc[3 * i + 1], anc[3 * i + 2], nrm[3 * i],
                nrm[3 * i + 1], nrm[3 * i + 2], wgt[i]};
            const KDual6 rj =
                plane_residual(sm.tan.pose_d[h], sm.tan.slerp_d[h], row);
#pragma unroll
            for (int j = 0; j < kTan; ++j) jac[j] = rj.d[j];
            r = rj.v;
          }
          float* mine = chunk + (i - base) * kChunkStride + kTan * h;
#pragma unroll
          for (int j = 0; j < kTan; ++j) mine[j] = jac[j];
          if (h == 1) mine[kTan] = r;
        }
        row_barrier();
        MARK(2);
        if (tid < kSums * kGroups) {
          const int s = tid % kSums, grp = tid / kSums;
          const int glen = (len + kGroups - 1) / kGroups;
          const int q1 = min(len, (grp + 1) * glen);
          const int pa = sm.pair[s][0], pc = sm.pair[s][1];
          float acc = 0.0f;
#pragma unroll 4
          for (int q = grp * glen; q < q1; ++q) {
            const float* cq = chunk + q * kChunkStride;
            acc += cq[pa] * cq[pc];
          }
          sm.grp[grp][s] = acc;
        }
        row_barrier();
        if (tid < kSums) {
          float v = sm.grp[0][tid];
#pragma unroll
          for (int q = 1; q < kGroups; ++q) v += sm.grp[q][tid];
          sm.part[tid] = base == 0 ? v : sm.part[tid] + v;
        }
        MARK(3);
      }
    }
    // ---- B: every CTA's partial sums and the pose rows are in
    cluster_barrier();
    MARK(4);
    if (rank == 0 && tid < kSums)
      sm.sums[tid] = cluster_sum(cluster, sm.part + tid, ranks);
    // the last iteration: no CTA leaves while rank 0 reads its sums
    if (it == a.iters) cluster_barrier();
    if (rank != 0) continue;
    __syncthreads();
    MARK(5);

    // ---- rank 0: the pose rows added, the frame's system
    const int q0 = gn ? 0 : 8;    // blocks: no continuity rows
    if (tid < 78) {
      const int pa = sm.pair[tid][0], pc = sm.pair[tid][1];
      float s = sm.sums[tid];
      for (int q = q0; q < kPoseRows; ++q) s += sm.pj[q][pa] * sm.pj[q][pc];
      sm.jtj[12 * pa + pc] = s;
      sm.jtj[12 * pc + pa] = s;
    } else if (tid < 90) {
      const int pa = tid - 78;
      float s = sm.sums[tid];
      for (int q = q0; q < kPoseRows; ++q) s += sm.pj[q][pa] * sm.pr[q];
      sm.jtr[pa] = s;
    } else if (tid == 90) {
      float cont = 0.0f, pri = 0.0f;
      for (int q = 0; q < 8; ++q) cont += sm.pr[q] * sm.pr[q];
      for (int q = 8; q < kPoseRows; ++q) pri += sm.pr[q] * sm.pr[q];
      // each interior edge appears in both of its frames' rows: halved
      sm.cost = gn ? (sm.sums[90] + 0.5f * cont) + pri : sm.sums[90] + pri;
    }
    __syncthreads();
    MARK(6);
    if (it == a.iters) {
      for (int v = tid; v < 144; v += kThreads) a.jtj[144 * f + v] = sm.jtj[v];
      if (tid < 12) a.jtr[12 * f + tid] = sm.jtr[tid];
      if (tid == 0) a.cost[f] = sm.cost;
    }
    if (!gn) continue;
    // ---- the Jacobi-scaled damped solve, the update of the pose
    if (tid < 12) sm.dsc[tid] = sqrtf(fmaxf(sm.jtj[13 * tid], 1e-12f));
    __syncthreads();
    if (tid < 78) {
      const int pa = sm.pair[tid][0], pc = sm.pair[tid][1];   // pa <= pc
      float v = sm.jtj[12 * pa + pc] / (sm.dsc[pa] * sm.dsc[pc]);
      if (pa == pc) v = v + a.damping;
      sm.chol[pc * (pc + 1) / 2 + pa] = v;
    } else if (tid < 90) {
      sm.rhs[tid - 78] = -sm.jtr[tid - 78] / sm.dsc[tid - 78];
    }
    __syncthreads();
    if (tid == 0) cholesky12(sm.chol, sm.rhs);
    __syncthreads();
    if (tid < 12) sm.rhs[tid] = sm.rhs[tid] / sm.dsc[tid];
    __syncthreads();
    const bool more = it < a.iters;
    if (tid == 0) {
      const Pose<float> np = apply_delta(sm.rhs, pose_from<float>(sm.pose));
      const float o[14] = {np.qb.w, np.qb.x, np.qb.y, np.qb.z, np.tb.x,
                           np.tb.y, np.tb.z, np.qe.w, np.qe.x, np.qe.y,
                           np.qe.z, np.te.x, np.te.y, np.te.z};
      float* out = more ? a.iterates + (it & 1) * a.nf * 14 + 14 * f
                        : a.poses_out + 14 * f;
#pragma unroll
      for (int v = 0; v < 14; ++v) {
        sm.pose[v] = o[v];
        out[v] = o[v];
      }
      // the neighbours may read it: release this frame's flag
      if (more) store_release(a.flags + 1 + f, it);
    }
    __syncthreads();
    MARK(7);
    if (!more) continue;
    if (warp == 0 && lane < 12) {
      // the new pose's tangents, for the cluster
      pose_tangents(sm.pose, lane, sm.tan);
    } else if (poser) {
      // ---- the next iteration's pose rows, while the cluster goes on:
      // arrive at its barrier A first
      cluster_arrive();
      if (lane < 24) {
        const long long t0 = clock64();
        const long long w = build_pose_rows(a, sm, sm.pose, f, it + 1, lane);
#ifdef K8_MARKS
        if (f == 0 && lane == 0) {
          pw_wait += w;
          pw_rows += clock64() - t0 - w;
        }
#else
        (void)t0;
        (void)w;
#endif
      }
    }
    MARK(8);
  }

  // ---- the last cluster to finish: the total in frame order, the flags
  // and the counter left zero
  if (rank == 0) {
    __threadfence();
    __syncthreads();
    if (tid == 0) sm.last = atomicAdd(a.flags, 1) == a.nf - 1;
    __syncthreads();
    if (sm.last) {
      __threadfence();
      if (tid == 0) {
        float t = __ldcg(a.cost);
        for (int q = 1; q < a.nf; ++q) t += __ldcg(a.cost + q);
        a.total[0] = t;
        a.flags[0] = 0;
      }
      for (int q = tid; q < a.nf; q += kThreads) a.flags[1 + q] = 0;
    }
    MARK(11);
  }
#ifdef K8_MARKS
  if (poser && f == 0 && lane == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(&g_marks[0][9]),
              static_cast<unsigned long long>(pw_wait));
    atomicAdd(reinterpret_cast<unsigned long long*>(&g_marks[0][10]),
              static_cast<unsigned long long>(pw_rows));
  }
  if (timed) {
    ph[12] = 1;
    ph[13] = gtimer() - g0;
    ph[14] = clock64() - c0;
    for (int q = 0; q < kMarks; ++q)
      if (q != 9 && q != 10)
        atomicAdd(reinterpret_cast<unsigned long long*>(&g_marks[rank][q]),
                  static_cast<unsigned long long>(ph[q]));
  }
#endif
}
#undef MARK

// The shared-memory and non-portable-cluster attributes, once a process.
int setup() {
  static bool done = false;
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      ct_ba_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSharedBytes + kChunkBytes + kRowsOnChip * kRowFloats * 4);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        ct_ba_block_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

}  // namespace

// The CTAs of a frame's cluster for F frames of K rows: 16, or 8 where F
// clusters of 16 cannot all be resident at once; 0 where F clusters of 8
// cannot be either (a launch that waits across clusters would then hang:
// the wrapper raises); a negative CUDA error.
extern "C" int k8_cluster(int nf, int rows) {
  const int err = setup();
  if (err != 0) return -err;
  for (int c = kMaxCluster; c >= 8; c /= 2) {
    const int per = rows > 0 ? (rows + c - 1) / c : 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSharedBytes + kChunkBytes +
                           (per <= kRowsOnChip ? per * kRowFloats * 4 : 0);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&n, ct_ba_block_kernel, &cfg);
    if (e != cudaSuccess) return -static_cast<int>(e);
    if (n >= nf) return c;
  }
  return 0;
}

// One launch: mode 0 `iters` block-Jacobi inner iterations (poses_out, and
// the last iteration's cost, total, J^T J, J^T r), mode 1 (iters 1) the
// point + prior blocks (cost, total, J^T J, J^T r). `cluster` from
// k8_cluster (or 16 where one iteration waits on no other cluster).
// iterates: f32 [2, F, 14] scratch; flags: int32 [1 + F], zero, left zero;
// halo: f32 [2, 16] or null (mode 0 with one iteration only).
extern "C" int k8_ct_ba_block(
    const void* poses_in, void* poses_out, void* iterates, const void* raw,
    const void* alphas, const void* anchors, const void* normals,
    const void* weights, const void* pqb, const void* ptb, const void* pqe,
    const void* pte, const void* prior_weight, const void* edge_alpha,
    const void* halo, int nf, int k, int cluster, float beta, float damping,
    int mode, int iters, void* flags, void* cost, void* total, void* jtj,
    void* jtr, void* stream) {
  if (nf < 1 || nf > 65535 || k < 0 || (mode != 0 && mode != 1) ||
      iters < 1 || (mode == 1 && iters != 1) ||
      (halo != nullptr && (mode != 0 || iters != 1)) ||
      (cluster != 8 && cluster != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = setup();
  if (err != 0) return err;
  Args a;
  a.poses_in = static_cast<const float*>(poses_in);
  a.poses_out = static_cast<float*>(poses_out);
  a.iterates = static_cast<float*>(iterates);
  a.raw = static_cast<const float*>(raw);
  a.alphas = static_cast<const float*>(alphas);
  a.anchors = static_cast<const float*>(anchors);
  a.normals = static_cast<const float*>(normals);
  a.weights = static_cast<const float*>(weights);
  a.pqb = static_cast<const float*>(pqb);
  a.ptb = static_cast<const float*>(ptb);
  a.pqe = static_cast<const float*>(pqe);
  a.pte = static_cast<const float*>(pte);
  a.prior_weight = static_cast<const float*>(prior_weight);
  a.edge_alpha = static_cast<const float*>(edge_alpha);
  a.halo = static_cast<const float*>(halo);
  a.flags = static_cast<int*>(flags);
  a.cost = static_cast<float*>(cost);
  a.total = static_cast<float*>(total);
  a.jtj = static_cast<float*>(jtj);
  a.jtr = static_cast<float*>(jtr);
  a.nf = nf;
  a.k = k;
  a.rows_per_cta = k > 0 ? (k + cluster - 1) / cluster : 0;
  a.on_chip = a.rows_per_cta <= kRowsOnChip ? 1 : 0;
  a.mode = mode;
  a.iters = iters;
  a.beta = beta;
  a.damping = damping;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, nf);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      kSharedBytes + kChunkBytes +
      (a.on_chip ? a.rows_per_cta * kRowFloats * 4 : 0);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ct_ba_block_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

#ifdef K8_MARKS
// Copy the marks (int64 [2][15], host memory) into `out` and zero them.
extern "C" int k8_read_marks(void* out) {
  const long long zeros[2][kMarks] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_marks, sizeof(zeros));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_marks, zeros, sizeof(zeros));
  return static_cast<int>(e);
}
#endif
