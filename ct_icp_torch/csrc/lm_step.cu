// K5 lm_step: the Levenberg-Marquardt inner loop of CT-ICP, every step of
// one LM call in one launch, its state on the device.
//
// Replaces ct_icp_tpu/icp/solver.py:418-539 (_lm_inner_loop) for every
// statics the solver takes: the residual families point-to-plane,
// point-to-point, point-to-line, point-to-distribution and the ROBUST
// solver's mixed rows (a template instance each: Family below; the analytic
// rows of the four distances an instance each beside them, and the
// point-to-plane rows with the Cauchy loss, the production default, one
// with the loss as its type), the losses
// STANDARD, CAUCHY, HUBER, TOLERANT and TRUNCATED (a kernel argument: a few
// operations in the weight and the cost), the [14] motion prior or the
// [41] prior with its 12 prediction-consistency rows, the Jacobian by
// forward mode or (flag, not for ROBUST) analytic, by cross products from
// the world-point gradient, and the begin-column freeze of SIMPLE (flag).
// The reference runs the loop as a lax.while_loop (it < n and ~done) inside
// one XLA program. Here one launch of a thread-block cluster of 16 CTAs
// runs it (a non-portable size, which the H100 schedules; a card that
// refuses it fails the launch). Each CTA keeps its share of the rows in
// shared memory for the whole call (rows beyond what the cluster holds are
// read from global memory, where they stay in L2).
// A step:
//
//   1. rows: each kept row's R scalar residuals (R = 3 for point-to-point
//      and ROBUST, else 1) at delta = 0 and their 12 tangents by forward
//      mode (the arithmetic of jax.jacfwd, branches of quat_slerp included:
//      the sign flip, the clip and the nlerp fallback), in two passes of 6
//      tangents (begin, end) through the pose's own tangents and slerp
//      setup, which a thread a column computes at the start of the step (and
//      another warp the prior rows' Jacobian); or, analytic, the residuals
//      and their world-point gradient at the pose and the tangents by cross
//      products (residuals.ct_jacobian_from_world_grad);
//      the IRLS weight of each scalar row; per chunk of 256 rows, the 78
//      sums of J^T W J, the 12 of J^T W r and the cost, each by one warp;
//   2. every CTA sums the cluster's partials (distributed shared memory, in
//      CTA order) and does the pose-level work itself, so nothing has to be
//      broadcast: the prior rows added, the degenerate-column freeze, the
//      Jacobi scaling, the damping, the 12x12 solve (one warp, a lane a
//      row: the partial pivoting of a serial elimination, ties to the
//      first row) and the trial pose;
//   3. rows: the robust cost at the trial pose, summed the same way (one
//      thread meanwhile: the prior's cost there, the pose a rejection keeps);
//   4. accept/reject, lambda, cost0, the pose update and `done` (Ceres'
//      function tolerance). The loop leaves at done, as the reference's
//      while_loop does, or after n_steps.
// Two cluster barriers a step. No float atomics: a run repeats bit for
// bit, and every CTA computes the same solve from the same sums. A row that
// is not kept adds R rho(0) to the costs, as the reference's masked zeros
// do (non-zero for TOLERANT only).
//
// Bound: the rows are read once a call (48-100 B a row); a step is ~1,100
// float operations a kept point-to-plane row (3.2 Mflop at K = 2,941: 0.05
// us at 67 TFLOP/s). The loop is bound by its serial chain, not by bytes or
// operations: the two cluster barriers, the pose-level work and the solve
// of every step.
//
// state (f32[200], see kernels/lm_step.py): 0:14 pose (qb, tb, qe, te),
// 14 lambda, 15 cost0 (NaN until the first step), 16 done, 17 trial cost,
// 18:30 delta, 30:44 trial pose, 44:56 J^T W r, 56:200 J^T W J; after the
// call, 17:200 hold the last step's values.
//
// rows (kernels/lm_step.py::pack_rows): raw 3, alpha, anchor 3, then the
// family's fields, the geometric weight and ok last: PLANE the normal,
// POINT 3 unused, LINE the line, DISTRIBUTION the covariance inverse (9),
// ROBUST the normal, the line, the covariance inverse and the class.
//
// The source builds one library a family: -DK5_FAMILY=f (Family below)
// instantiates that family's kernels alone (kernels/build.py::PARTS), so
// that the families' builds run side by side on the host's cores.
//
// Measurement variants (tools/exp_lm_loop.py builds them; the main path
// never does): -DK5_CLUSTER=n launches n CTAs; -DK5_MARKS makes CTA 0's
// thread 0 add the clock cycles of each phase of every step to a device
// array that k5_read_marks returns.
//
// The dual numbers, the SE3 formulas, the point-to-plane row and the
// warp's 12x12 solve are in dual.cuh, shared with K8 ct_ba_block.
#include <cooperative_groups.h>

#include <cmath>
#include <cstddef>

#include "common.cuh"
#include "dual.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cticp;

constexpr int kThreads = 256;        // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 91;            // 78 of J^T W J, 12 of J^T W r, 1 cost
constexpr int kStateSize = 200;
constexpr int kMaxPrior = 22;        // 10 motion-model rows + 12 prediction
constexpr int kSmemLimit = 232448;   // a CTA's shared memory (227 KB)
#ifndef K5_CLUSTER
#define K5_CLUSTER 16
#endif
#ifndef K5_FAMILY
#error "build with -DK5_FAMILY=f, one library a residual family"
#endif
constexpr int kCluster = K5_CLUSTER; // CTAs of the launch
static_assert(kCluster >= 1 && kCluster <= 16, "a cluster is 1..16 CTAs");

// the residual families (kernels/lm_step.py::Family)
enum Family { kPlane = 0, kPoint = 1, kLine = 2, kDist = 3, kRobust = 4 };
// the losses (kernels/lm_step.py::_LOSS)
enum LossKind { kStandard = 0, kCauchy = 1, kHuber = 2, kTolerant = 3,
                kTruncated = 4 };
// flags
constexpr int kFreezeBegin = 1, kUseDistribution = 2, kAnalytic = 4;

template <int F>
struct Fam {
  // floats a packed row, scalar residual rows a packed row
  static constexpr int kRow = F == kDist ? 18 : (F == kRobust ? 25 : 12);
  static constexpr int kR = (F == kPoint || F == kRobust) ? 3 : 1;
  static constexpr int kW = kRow - 2, kOk = kRow - 1;  // weight, ok columns
  // the chunk: jac 12, r, w a scalar row (odd stride: no bank conflicts)
  static constexpr int kChunkStride = 14 * kR + 1;
};

#ifdef K5_MARKS
// the phases of a step, as the cycle marks count them: the column threads,
// the row pass, barrier 1, the cluster sums, J^T W J assembly, the scaling
// and the solve, the trial pose, the trial-cost pass, barrier 2,
// accept/reject
constexpr int kPhases = 10;
__device__ long long g_marks[kPhases];
#define MARK(k)                        \
  if (timed) {                         \
    const long long t_now = clock64(); \
    phase[k] += t_now - t_mark;        \
    t_mark = t_now;                    \
  }
#else
#define MARK(k)
#endif

constexpr int S_LAM = 14, S_COST0 = 15, S_DONE = 16, S_COST1 = 17;
constexpr int S_DELTA = 18, S_TRIAL = 30, S_JTR = 44, S_JTJ = 56;

// ------------------------------------------------------------- losses —
// residuals.irls_weight / robust_cost at r2 = r^2 (b = sigma^2, s =
// max(sigma, 1e-9), a = the TOLERANT threshold)
struct Loss {
  int kind;
  float b, sigma, a, s;
};

__device__ __forceinline__ float loss_weight(const Loss& L, float r2) {
  switch (L.kind) {
    case kStandard:
      return 1.0f;
    case kCauchy:
      return 1.0f / (1.0f + r2 / L.b);
    case kHuber:
      return fminf(L.sigma / sqrtf(fmaxf(r2, 1e-20f)), 1.0f);
    case kTolerant:
      return 1.0f / (1.0f + expf(-((r2 - L.a) / L.s)));
    default:
      return r2 < L.b ? 1.0f : 0.0f;
  }
}

__device__ __forceinline__ float loss_cost(const Loss& L, float r2) {
  switch (L.kind) {
    case kStandard:
      return r2;
    case kCauchy:
      return L.b * log1pf(r2 / L.b);
    case kHuber:
      return r2 <= L.b ? r2 : 2.0f * sqrtf(L.b * fmaxf(r2, 0.0f)) - L.b;
    case kTolerant: {
      // s * logaddexp(x, 0) = s * (max(x, 0) + log1p(exp(-|x|)))
      const float x = (r2 - L.a) / L.s;
      return L.s * (fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))));
    }
    default:
      return fminf(r2, L.b);
  }
}

// The point-to-plane Cauchy instance (the production default) takes the
// loss as its type: no branch on the loss in its rows' code (without it
// the 20- and 5-step calls of tools/exp_k5_trees.py take 2.7 % and 4.4 %
// longer, PERF.md B6).
template <bool kCauchyRows>
__device__ __forceinline__ float row_weight(const Loss& L, float r2) {
  if constexpr (kCauchyRows) return 1.0f / (1.0f + r2 / L.b);
  return loss_weight(L, r2);
}

template <bool kCauchyRows>
__device__ __forceinline__ float row_cost(const Loss& L, float r2) {
  if constexpr (kCauchyRows) return L.b * log1pf(r2 / L.b);
  return loss_cost(L, r2);
}

// ---------------------------------------------------------- prior rows —
// the 10 motion-prior rows (residuals.motion_prior_residuals) at pose p
template <class T>
__device__ __forceinline__ void prior_residuals(const Pose<T>& p,
                                                const float* prior, float n,
                                                T* r) {
  const float w_loc = sqrtf(n * prior[10]);
  const float w_or = sqrtf(n * prior[11]);
  const float w_cv = sqrtf(n * prior[12]);
  const float w_sv = sqrtf(n * prior[13]);
  r[0] = w_loc * (p.tb.x - prior[4]);
  r[1] = w_loc * (p.tb.y - prior[5]);
  r[2] = w_loc * (p.tb.z - prior[6]);
  const Quat<T> q = quat_normalize(p.qb);
  const T dotq =
      q.w * prior[0] + q.x * prior[1] + q.y * prior[2] + q.z * prior[3];
  r[3] = w_or * (1.0f - dotq * dotq);
  r[4] = w_cv * ((p.te.x - p.tb.x) - prior[7]);
  r[5] = w_cv * ((p.te.y - p.tb.y) - prior[8]);
  r[6] = w_cv * ((p.te.z - p.tb.z) - prior[9]);
  r[7] = w_sv * (p.tb.x - p.te.x);
  r[8] = w_sv * (p.tb.y - p.te.y);
  r[9] = w_sv * (p.tb.z - p.te.z);
}

template <class T>
__device__ __forceinline__ T quat_dot(const Quat<T>& q, const float* p) {
  return q.w * p[0] + q.x * p[1] + q.y * p[2] + q.z * p[3];
}

// the 12 prediction-consistency rows
// (residuals.prediction_consistency_residuals) of a [41] prior at pose p
template <class T>
__device__ __forceinline__ void prediction_residuals(const Pose<T>& p,
                                                     const float* prior,
                                                     T* r) {
  const Quat<T> qbn = quat_normalize(p.qb);
  const Quat<T> qen = quat_normalize(p.qe);
  r[0] = prior[35] * (p.tb.x - prior[18]);
  r[1] = prior[35] * (p.tb.y - prior[19]);
  r[2] = prior[35] * (p.tb.z - prior[20]);
  const T dq_b = quat_dot(qbn, prior + 14);
  r[3] = prior[36] * (1.0f - dq_b * dq_b);
  r[4] = prior[37] * (p.te.x - prior[25]);
  r[5] = prior[37] * (p.te.y - prior[26]);
  r[6] = prior[37] * (p.te.z - prior[27]);
  const T dq_e = quat_dot(qen, prior + 21);
  r[7] = prior[38] * (1.0f - dq_e * dq_e);
  // se3_compose(se3_inverse(qbn, tb), qen, te)
  const Quat<T> qn = quat_normalize(qbn);
  const Quat<T> qi{qn.w, -qn.x, -qn.y, -qn.z};
  const Vec3<T> ri = quat_rotate(qi, p.tb);
  const Vec3<T> ti{-ri.x, -ri.y, -ri.z};
  const Quat<T> rq = quat_normalize(quat_mul(qi, qen));
  const Vec3<T> rr = quat_rotate(quat_normalize(qi), p.te);
  const Vec3<T> rt{rr.x + ti.x, rr.y + ti.y, rr.z + ti.z};
  const T dq_r = quat_dot(quat_normalize(rq), prior + 28);
  r[8] = prior[39] * (1.0f - dq_r * dq_r);
  r[9] = prior[40] * (rt.x - prior[32]);
  r[10] = prior[40] * (rt.y - prior[33]);
  r[11] = prior[40] * (rt.z - prior[34]);
}

template <class T>
__device__ __forceinline__ void all_prior_rows(const Pose<T>& p,
                                               const float* prior, float n,
                                               int n_prior, T* r) {
  prior_residuals(p, prior, n, r);
  if (n_prior >= 41) prediction_residuals(p, prior, r + 10);
}

// ------------------------------------------------------- the row rows —
// the world point of a row at pose p (s = its slerp setup), as
// plane_residual computes it
template <class T>
__device__ __forceinline__ Vec3<T> row_world(const Pose<T>& p,
                                             const Slerp<T>& s,
                                             const float* row) {
  const float a = row[3];
  const Quat<T> qi = slerp_at(s, a);
  const Vec3<T> raw{T{row[0]}, T{row[1]}, T{row[2]}};
  const Vec3<T> rot = quat_rotate(qi, raw);
  const float b = 1.0f - a;
  return {rot.x + (b * p.tb.x + a * p.te.x), rot.y + (b * p.tb.y + a * p.te.y),
          rot.z + (b * p.tb.z + a * p.te.z)};
}

// d / max(|d|, 1e-12), a row's line direction (a constant)
__device__ __forceinline__ Vec3<float> unit_line(const float* l) {
  const float n = fmaxf(sqrtf((l[0] * l[0] + l[1] * l[1]) + l[2] * l[2]),
                        1e-12f);
  return {l[0] / n, l[1] / n, l[2] / n};
}

// residuals.geometric_residuals of a diff, a distance at a time
template <class T>
__device__ __forceinline__ T plane_of(const Vec3<T>& d, const float* n,
                                      float w) {
  return w * ((d.x * n[0] + d.y * n[1]) + d.z * n[2]);
}

template <class T>
__device__ __forceinline__ T line_of(const Vec3<T>& d, const float* line,
                                     float w) {
  const Vec3<float> u = unit_line(line);
  const T cx = u.y * d.z - u.z * d.y;
  const T cy = u.z * d.x - u.x * d.z;
  const T cz = u.x * d.y - u.y * d.x;
  return w * tsqrt(((cx * cx + cy * cy) + cz * cz) + T{1e-12f});
}

template <class T>
__device__ __forceinline__ T dist_of(const Vec3<T>& d, const float* c,
                                     float w) {
  const T c0 = (c[0] * d.x + c[1] * d.y) + c[2] * d.z;
  const T c1 = (c[3] * d.x + c[4] * d.y) + c[5] * d.z;
  const T c2 = (c[6] * d.x + c[7] * d.y) + c[8] * d.z;
  return w * ((d.x * c0 + d.y * c1) + d.z * c2);
}

// The R residuals of a row at pose p (solver.py::_residual_vector).
template <int F, class T>
__device__ __forceinline__ void row_residuals(const Pose<T>& p,
                                              const Slerp<T>& s,
                                              const float* row, int flags,
                                              T* r) {
  if constexpr (F == kPlane) {
    r[0] = plane_residual(p, s, row);
    return;
  }
  const Vec3<T> w = row_world(p, s, row);
  const Vec3<T> d{w.x - row[4], w.y - row[5], w.z - row[6]};
  const float wt = row[Fam<F>::kW];
  if constexpr (F == kPoint) {
    r[0] = wt * d.x;
    r[1] = wt * d.y;
    r[2] = wt * d.z;
  } else if constexpr (F == kLine) {
    r[0] = line_of(d, row + 7, wt);
  } else if constexpr (F == kDist) {
    r[0] = dist_of(d, row + 7, wt);
  } else {  // ROBUST: by the neighbourhood's class
    const float cls = row[22];
    if (cls == 1.0f || cls == 2.0f) {
      r[0] = cls == 1.0f ? plane_of(d, row + 7, wt) : line_of(d, row + 10, wt);
      r[1] = T{0.0f};
      r[2] = T{0.0f};
    } else if (flags & kUseDistribution) {
      r[0] = dist_of(d, row + 13, wt);
      r[1] = T{0.0f};
      r[2] = T{0.0f};
    } else {
      r[0] = wt * d.x;
      r[1] = wt * d.y;
      r[2] = wt * d.z;
    }
  }
}

// The analytic branch (solver.py:460-470): the R residuals of a row at the
// pose p and their 12 tangents from the world-point gradient
// (residuals.geometric_residuals_and_grad, ct_jacobian_from_world_grad).
template <int F>
__device__ __forceinline__ void row_analytic(const Pose<float>& p,
                                             const Slerp<float>& s,
                                             const float* row, float* r,
                                             float jac[][12]) {
  const Vec3<float> w = row_world(p, s, row);
  const Vec3<float> d{w.x - row[4], w.y - row[5], w.z - row[6]};
  const float wt = row[Fam<F>::kW];
  float g[Fam<F>::kR][3];
  if constexpr (F == kPlane) {
    r[0] = plane_of(d, row + 7, wt);
    for (int c = 0; c < 3; ++c) g[0][c] = wt * row[7 + c];
  } else if constexpr (F == kPoint) {
    r[0] = wt * d.x;
    r[1] = wt * d.y;
    r[2] = wt * d.z;
    for (int u = 0; u < Fam<F>::kR; ++u)
      for (int c = 0; c < 3; ++c) g[u][c] = u == c ? wt : 0.0f * wt;
  } else if constexpr (F == kLine) {
    const Vec3<float> u = unit_line(row + 7);
    const Vec3<float> c = cross(u, d);
    const float nc = sqrtf(((c.x * c.x + c.y * c.y) + c.z * c.z) + 1e-12f);
    r[0] = wt * nc;
    const Vec3<float> ch{c.x / nc, c.y / nc, c.z / nc};
    const Vec3<float> gg = cross(u, ch);
    g[0][0] = wt * -gg.x;
    g[0][1] = wt * -gg.y;
    g[0][2] = wt * -gg.z;
  } else {
    const float* c = row + 7;
    const float c0 = (c[0] * d.x + c[1] * d.y) + c[2] * d.z;
    const float c1 = (c[3] * d.x + c[4] * d.y) + c[5] * d.z;
    const float c2 = (c[6] * d.x + c[7] * d.y) + c[8] * d.z;
    r[0] = wt * ((d.x * c0 + d.y * c1) + d.z * c2);
    g[0][0] = wt * (2.0f * c0);
    g[0][1] = wt * (2.0f * c1);
    g[0][2] = wt * (2.0f * c2);
  }
  const float a = row[3];
  const Vec3<float> v{w.x - ((1.0f - a) * p.tb.x + a * p.te.x),
                      w.y - ((1.0f - a) * p.tb.y + a * p.te.y),
                      w.z - ((1.0f - a) * p.tb.z + a * p.te.z)};
  for (int u = 0; u < Fam<F>::kR; ++u) {
    const Vec3<float> gu{g[u][0], g[u][1], g[u][2]};
    const Vec3<float> rot = cross(v, gu);
    const float rc[3] = {rot.x, rot.y, rot.z};
    for (int c = 0; c < 3; ++c) {
      jac[u][c] = (1.0f - a) * rc[c];
      jac[u][3 + c] = (1.0f - a) * g[u][c];
      jac[u][6 + c] = a * rc[c];
      jac[u][9 + c] = a * g[u][c];
    }
  }
}

// The sum over the cluster's CTAs, in CTA order, of the float at `local`
// in each CTA's shared memory: the remote loads issued together, then
// added in order.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* local) {
  float v[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) v[q] = *cluster.map_shared_rank(local, q);
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kCluster; ++q) s += v[q];
  return s;
}

// ------------------------------------------------------- shared memory —
// One CTA's state, then the chunk buffer [kThreads][kChunkStride], then the
// CTA's rows [rows][kRow] when they are kept on chip.
struct Shared {
  float state[kStateSize];
  float part_a[kSums + 1];       // this CTA's sums (read by the cluster)
  float sums[kSums + 1];         // the cluster's
  float part_c[4];               // this CTA's trial cost
  float warp_c[kWarps];
  float pj[kMaxPrior][12];       // the prior's Jacobian
  float pr[kMaxPrior];           // the prior's residuals
  unsigned char pair[78][2];     // (a, c) of each J^T W J sum
  Pose<Dual6> pose_d[2];         // the pose's begin / end tangents
  Slerp<Dual6> slerp_d[2];
  Pose<float> pose0;             // their values (the analytic branch's pose)
  Slerp<float> slerp0;
  Pose<float> trial;
  Slerp<float> slerp_trial;
  Pose<float> same;              // the pose a rejected step keeps
  float trial_prior_cost;
};
template <int F>
constexpr int fixed_bytes() {
  return (static_cast<int>(sizeof(Shared)) + 15) / 16 * 16 +
         kThreads * Fam<F>::kChunkStride * 4;
}
// rows a CTA keeps in shared memory: 4,096, or what fits beside the rest
template <int F>
constexpr int rows_on_chip() {
  return (kSmemLimit - fixed_bytes<F>()) / (Fam<F>::kRow * 4) < 4096
             ? (kSmemLimit - fixed_bytes<F>()) / (Fam<F>::kRow * 4)
             : 4096;
}
static_assert(rows_on_chip<kPlane>() == 4096 && rows_on_chip<kRobust>() > 0,
              "a CTA's shared memory is 227 KB");

// A value and the Dual6 tangents' values of a pose / slerp setup.
__device__ __forceinline__ Pose<float> values(const Pose<Dual6>& p) {
  return {{p.qb.w.v, p.qb.x.v, p.qb.y.v, p.qb.z.v},
          {p.tb.x.v, p.tb.y.v, p.tb.z.v},
          {p.qe.w.v, p.qe.x.v, p.qe.y.v, p.qe.z.v},
          {p.te.x.v, p.te.y.v, p.te.z.v}};
}

// ------------------------------------------------------------- the loop —
template <int F, bool kAnalyticRows, bool kCauchyRows>
__global__ void __launch_bounds__(kThreads, 1)
    lm_loop_kernel(const float* __restrict__ rows, int k, int rows_per_cta,
                   int on_chip, const float* __restrict__ prior, int n_prior,
                   const int32_t* __restrict__ n_res, float* state,
                   int n_steps, Loss loss, int flags, int32_t* steps_run) {
  using Fm = Fam<F>;
  constexpr int kRow = Fm::kRow, kR = Fm::kR, kStride = Fm::kChunkStride;
  const int freeze_begin = flags & kFreezeBegin;
  // the analytic rows: an instance of their own, so that the forward-mode
  // rows' code (and its registers) stays as it was
  constexpr bool analytic = kAnalyticRows && F != kRobust;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 dyn[];
  Shared& sm = *reinterpret_cast<Shared*>(dyn);
  float* chunk = reinterpret_cast<float*>(reinterpret_cast<char*>(dyn) +
                                          (sizeof(Shared) + 15) / 16 * 16);
  float* srows = chunk + kThreads * kStride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int r0 = rank * rows_per_cta;
  const int nrows = max(0, min(rows_per_cta, k - r0));
  const float* my_rows = rows + static_cast<size_t>(kRow) * r0;
  if (on_chip) {
    for (int v = tid; v < nrows * kRow; v += kThreads) srows[v] = my_rows[v];
    my_rows = srows;
  }
  for (int v = tid; v < kStateSize; v += kThreads) sm.state[v] = state[v];
  if (tid < 78) {
    int a = 0, s = tid;
    while (s >= 12 - a) s -= 12 - a++;
    sm.pair[tid][0] = static_cast<unsigned char>(a);
    sm.pair[tid][1] = static_cast<unsigned char>(a + s);
  }
  const float n = fmaxf(static_cast<float>(*n_res), 0.0f);
  const int np = n_prior >= 41 ? 22 : 10;  // prior rows
  // a row that is not kept: R scalar zeros, R rho(0) (0 but for TOLERANT)
  const float rho0 = loss_cost(loss, 0.0f);
  const float off_cost = kR * rho0;
  __syncthreads();

#ifdef K5_MARKS
  const bool timed = rank == 0 && tid == 0;
  long long phase[kPhases] = {}, t_mark = timed ? clock64() : 0;
#endif
  int it = 0;
  while (it < n_steps && sm.state[S_DONE] == 0.0f) {
    // ---- a thread a column: the pose's tangent and the slerp setup's
    // (warp 0), the prior rows' (warp 1, from the same pose tangent)
    if (lane < 12 && warp < 2) {
      const int j = lane;
      Dual1 d[12];
#pragma unroll
      for (int c = 0; c < 12; ++c) {
        d[c] = Dual1{0.0f};
        if (c == j) d[c].d[0] = 1.0f;
      }
      const Pose<Dual1> pd = apply_delta(d, pose_from<Dual1>(sm.state));
      if (warp == 0) {
        const Slerp<Dual1> sl = slerp_setup(pd.qb, pd.qe);
        scatter_tangent(pd, sm.pose_d[j / kTan], j % kTan, 14);
        scatter_tangent(sl, sm.slerp_d[j / kTan], j % kTan, 10);
        if (j % kTan == 0) sm.slerp_d[j / kTan].near = sl.near;
      } else {
        Dual1 rr[kMaxPrior];
        all_prior_rows(pd, prior, n, n_prior, rr);
        // unrolled (the array stays in registers): the 10 motion-model
        // rows, then the prediction block's 12
#pragma unroll
        for (int q = 0; q < kMaxPrior; ++q) {
          if (q >= 10 && np == 10) break;
          sm.pj[q][j] = (freeze_begin && j < 6) ? 0.0f : rr[q].d[0];
          if (j == 0) sm.pr[q] = rr[q].v;
        }
      }
    }
    for (int s = tid; s < kSums; s += kThreads) sm.part_a[s] = 0.0f;
    __syncthreads();
    if constexpr (analytic) {
      // the analytic branch linearizes at the pose's values
      if (tid == 0) {
        sm.pose0 = values(sm.pose_d[0]);
        sm.slerp0 = slerp_setup(sm.pose0.qb, sm.pose0.qe);
      }
      __syncthreads();
    }
    MARK(0);

    // ---- 1. rows: residuals, Jacobian, weights; sums chunk by chunk
    for (int base = 0; base < nrows; base += kThreads) {
      const int i = base + tid;
      float jac[kR][12], r[kR], w[kR];
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        r[u] = 0.0f;
        w[u] = 0.0f;
#pragma unroll
        for (int j = 0; j < 12; ++j) jac[u][j] = 0.0f;
      }
      if (i < nrows && my_rows[kRow * i + Fm::kOk] != 0.0f) {
        const float* row = my_rows + kRow * i;
        if constexpr (analytic) {
          row_analytic<F>(sm.pose0, sm.slerp0, row, r, jac);
          if (freeze_begin) {
            for (int u = 0; u < kR; ++u)
              for (int j = 0; j < 6; ++j) jac[u][j] = 0.0f;
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h == 0 && freeze_begin) continue;
            Dual6 rj[kR];
            row_residuals<F>(sm.pose_d[h], sm.slerp_d[h], row, flags, rj);
#pragma unroll
            for (int u = 0; u < kR; ++u) {
#pragma unroll
              for (int j = 0; j < kTan; ++j) jac[u][kTan * h + j] = rj[u].d[j];
              r[u] = rj[u].v;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kR; ++u)
          w[u] = row_weight<kCauchyRows>(loss, r[u] * r[u]);
      }
      float* mine = chunk + tid * kStride;
#pragma unroll
      for (int u = 0; u < kR; ++u) {
#pragma unroll
        for (int j = 0; j < 12; ++j) mine[14 * u + j] = jac[u][j];
        mine[14 * u + 12] = r[u];
        mine[14 * u + 13] = w[u];
      }
      __syncthreads();
      const int len = min(kThreads, nrows - base);
      for (int s = warp; s < kSums; s += kWarps) {
        float acc = 0.0f;
        if (s < 78) {
          const int a = sm.pair[s][0], c = sm.pair[s][1];
          for (int q = lane; q < len; q += 32) {
            const float* cq = chunk + q * kStride;
#pragma unroll
            for (int u = 0; u < kR; ++u)
              acc += (cq[14 * u + a] * cq[14 * u + 13]) * cq[14 * u + c];
          }
        } else if (s < 90) {
          for (int q = lane; q < len; q += 32) {
            const float* cq = chunk + q * kStride;
#pragma unroll
            for (int u = 0; u < kR; ++u)
              acc += (cq[14 * u + s - 78] * cq[14 * u + 13]) *
                     cq[14 * u + 12];
          }
        } else {
          for (int q = lane; q < len; q += 32) {
            const float* cq = chunk + q * kStride;
#pragma unroll
            for (int u = 0; u < kR; ++u)
              acc += row_cost<kCauchyRows>(loss,
                                       cq[14 * u + 12] * cq[14 * u + 12]);
          }
        }
        acc = warp_sum(acc);
        if (lane == 0) sm.part_a[s] += acc;
      }
      __syncthreads();
    }
    MARK(1);
    cluster.sync();
    MARK(2);

    // ---- 2. the cluster's sums (CTA order), then the pose-level work
    if (tid < kSums) sm.sums[tid] = cluster_sum(cluster, sm.part_a + tid);
    __syncthreads();
    MARK(3);
    if (tid < 78) {
      const int a = sm.pair[tid][0], c = sm.pair[tid][1];
      float s = sm.sums[tid];
#pragma unroll
      for (int q = 0; q < 10; ++q) s += sm.pj[q][a] * sm.pj[q][c];
      if (np > 10) {
#pragma unroll
        for (int q = 10; q < kMaxPrior; ++q) s += sm.pj[q][a] * sm.pj[q][c];
      }
      sm.state[S_JTJ + 12 * a + c] = s;
      sm.state[S_JTJ + 12 * c + a] = s;
    } else if (tid < 90) {
      const int a = tid - 78;
      float s = sm.sums[tid];
#pragma unroll
      for (int q = 0; q < 10; ++q) s += sm.pj[q][a] * sm.pr[q];
      if (np > 10) {
#pragma unroll
        for (int q = 10; q < kMaxPrior; ++q) s += sm.pj[q][a] * sm.pr[q];
      }
      sm.state[S_JTR + a] = s;
    } else if (tid == 90) {
      float prior_cost = 0.0f;
#pragma unroll
      for (int q = 0; q < 10; ++q) prior_cost += sm.pr[q] * sm.pr[q];
      if (np > 10) {
#pragma unroll
        for (int q = 10; q < kMaxPrior; ++q) prior_cost += sm.pr[q] * sm.pr[q];
      }
      if (isnan(sm.state[S_COST0]))
        sm.state[S_COST0] = sm.sums[90] + prior_cost;
    }
    __syncthreads();
    MARK(4);
    if (warp == 0) {
      // degenerate-column freeze, Jacobi scaling, damping (solver.py:499-518)
      const float* jtj = sm.state + S_JTJ;
      float maxd = jtj[0];
#pragma unroll
      for (int a = 1; a < 12; ++a) maxd = fmaxf(maxd, jtj[13 * a]);
      const float thr = 1e-7f * fmaxf(maxd, 1e-12f);
      bool degen[12];
      float dsc[12], keep[12];
#pragma unroll
      for (int a = 0; a < 12; ++a) {
        degen[a] = jtj[13 * a] <= thr;
        keep[a] = degen[a] ? 0.0f : 1.0f;
        dsc[a] = degen[a] ? 1.0f : sqrtf(fmaxf(jtj[13 * a], 1e-20f));
      }
      const float lam = sm.state[S_LAM];
      const int a = lane < 12 ? lane : 0;
      float da = 1.0f, ka = 0.0f;
      bool ga = false;
#pragma unroll
      for (int c = 0; c < 12; ++c) {
        if (c == a) {
          da = dsc[c];
          ka = keep[c];
          ga = degen[c];
        }
      }
      float m[12], xs[12];
#pragma unroll
      for (int c = 0; c < 12; ++c) {
        float v = jtj[12 * a + c] / (da * dsc[c]);
        v = v * ka * keep[c];
        if (c == a && ga) v = v + 1.0f;
        if (c == a) v = (v + lam * v) + 1e-7f;
        m[c] = lane < 12 ? v : 0.0f;
      }
      const float x = lane < 12 ? -sm.state[S_JTR + a] / da * ka : 0.0f;
      solve12_warp(m, x, xs);
      if (lane == 0) {
        MARK(5);
        float delta[12];
#pragma unroll
        for (int c = 0; c < 12; ++c) {
          delta[c] = xs[c] / dsc[c] * keep[c];
          sm.state[S_DELTA + c] = delta[c];
        }
        const Pose<float> tr = apply_delta(delta, pose_from<float>(sm.state));
        const float tp[14] = {tr.qb.w, tr.qb.x, tr.qb.y, tr.qb.z,
                              tr.tb.x, tr.tb.y, tr.tb.z,
                              tr.qe.w, tr.qe.x, tr.qe.y, tr.qe.z,
                              tr.te.x, tr.te.y, tr.te.z};
#pragma unroll
        for (int c = 0; c < 14; ++c) sm.state[S_TRIAL + c] = tp[c];
        sm.trial = tr;
        sm.slerp_trial = slerp_setup(tr.qb, tr.qe);
      }
    }
    __syncthreads();
    MARK(6);

    // ---- 3. rows: the robust cost at the trial pose; beside them, one
    // thread: the prior's cost at the trial pose and the pose a rejected
    // step keeps (apply_delta(0): the translations stay, the quaternions
    // renormalise)
    if (tid == 32) {
      float pr[kMaxPrior];
      all_prior_rows(sm.trial, prior, n, n_prior, pr);
      float prior_cost = 0.0f;
#pragma unroll
      for (int q = 0; q < 10; ++q) prior_cost += pr[q] * pr[q];
      if (np > 10) {
#pragma unroll
        for (int q = 10; q < kMaxPrior; ++q) prior_cost += pr[q] * pr[q];
      }
      sm.trial_prior_cost = prior_cost;
      const float zero[12] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f,
                              0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      sm.same = apply_delta(zero, pose_from<float>(sm.state));
    }
    float cost = 0.0f;
    for (int i = tid; i < nrows; i += kThreads) {
      if (my_rows[kRow * i + Fm::kOk] != 0.0f) {
        float r[kR];
        row_residuals<F>(sm.trial, sm.slerp_trial, my_rows + kRow * i, flags,
                         r);
#pragma unroll
        for (int u = 0; u < kR; ++u)
          cost += row_cost<kCauchyRows>(loss, r[u] * r[u]);
      } else if (rho0 != 0.0f) {
        cost += off_cost;
      }
    }
    cost = warp_sum(cost);
    if (lane == 0) sm.warp_c[warp] = cost;
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int q = 0; q < kWarps; ++q) s += sm.warp_c[q];
      sm.part_c[0] = s;
    }
    MARK(7);
    cluster.sync();
    MARK(8);

    // ---- 4. accept / reject, lambda, cost0, the pose, done
    if (tid == 0) {
      const float c_pts = cluster_sum(cluster, sm.part_c);
      float* st = sm.state;
      const float cost1 = c_pts + sm.trial_prior_cost;
      const float cost0 = st[S_COST0];
      const bool accept = cost1 < cost0;
      const bool done = accept && (cost0 - cost1 <= 1e-6f * (cost0 + 1e-30f));
      st[S_COST1] = cost1;
      if (accept) {
        for (int a = 0; a < 14; ++a) st[a] = st[S_TRIAL + a];
      } else {
        const Pose<float>& same = sm.same;
        st[0] = same.qb.w;
        st[1] = same.qb.x;
        st[2] = same.qb.y;
        st[3] = same.qb.z;
        st[7] = same.qe.w;
        st[8] = same.qe.x;
        st[9] = same.qe.y;
        st[10] = same.qe.z;
      }
      const float lam = st[S_LAM];
      st[S_LAM] = accept ? fmaxf(lam / 3.0f, 1e-8f) : fminf(lam * 4.0f, 1e4f);
      st[S_COST0] = accept ? cost1 : cost0;
      st[S_DONE] = done ? 1.0f : 0.0f;
    }
    __syncthreads();
    MARK(9);
    ++it;
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
  if (rank == 0) {
    for (int v = tid; v < kStateSize; v += kThreads) state[v] = sm.state[v];
    if (tid == 0) atomicAdd(steps_run, it);
  }
#ifdef K5_MARKS
  if (timed)
    for (int k = 0; k < kPhases; ++k) g_marks[k] += phase[k];
#endif
}
#undef MARK

// The shared-memory and non-portable-cluster attributes, once a process
// an instance.
template <int F, bool kA, bool kC>
int setup() {
  static bool done = false;
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      lm_loop_kernel<F, kA, kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fixed_bytes<F>() + rows_on_chip<F>() * Fam<F>::kRow * 4);
  if (e == cudaSuccess && kCluster > 8)
    e = cudaFuncSetAttribute(lm_loop_kernel<F, kA, kC>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

// The instances: a family's forward-mode rows with any loss, its analytic
// rows (not ROBUST), and the point-to-plane forward-mode rows with the
// Cauchy loss.
template <int F, bool kA = false, bool kC = false>
int launch(const void* rows, int k, const void* prior, int n_prior,
           const void* n_res, void* state, int n_steps, Loss loss, int flags,
           void* steps_run, void* stream) {
  if constexpr (!kA && !kC && F != kRobust) {
    if (flags & kAnalytic)
      return launch<F, true>(rows, k, prior, n_prior, n_res, state, n_steps,
                             loss, flags, steps_run, stream);
  }
  if constexpr (!kA && !kC && F == kPlane) {
    if (loss.kind == kCauchy)
      return launch<F, false, true>(rows, k, prior, n_prior, n_res, state,
                                    n_steps, loss, flags, steps_run, stream);
  }
  const int err = setup<F, kA, kC>();
  if (err != 0) return err;
  const int per_cta = k > 0 ? (k + kCluster - 1) / kCluster : 0;
  const int on_chip = per_cta <= rows_on_chip<F>() ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      fixed_bytes<F>() + (on_chip ? per_cta * Fam<F>::kRow * 4 : 0);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, lm_loop_kernel<F, kA, kC>, static_cast<const float*>(rows), k,
      per_cta,
      on_chip, static_cast<const float*>(prior), n_prior,
      static_cast<const int32_t*>(n_res), static_cast<float*>(state), n_steps,
      loss, flags, static_cast<int32_t*>(steps_run));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rows the cluster keeps on chip for the library's family (beyond them
// the rows are read from global memory).
extern "C" int k5_rows_on_chip() {
  return kCluster * rows_on_chip<K5_FAMILY>();
}

#ifdef K5_MARKS
// Copy the cycle marks into `out` (int64 [10], host memory) and zero them.
extern "C" int k5_read_marks(void* out) {
  const long long zeros[kPhases] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_marks, sizeof(zeros));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_marks, zeros, sizeof(zeros));
  return static_cast<int>(e);
}
#endif

// Up to n_steps LM steps on `state`, in place; adds the steps run to
// steps_run (int32 [1]). family: Family, the library's own (K5_FAMILY);
// prior f32[n_prior] (14 or 41); loss: LossKind; flags: kFreezeBegin |
// kUseDistribution | kAnalytic.
extern "C" int k5_lm_loop(const void* rows, int k, int family,
                          const void* prior, int n_prior, const void* n_res,
                          void* state, int n_steps, int loss_kind,
                          float sigma, float tolerant_a, int flags,
                          void* steps_run, void* stream) {
  const Loss loss{loss_kind, sigma * sigma, sigma, tolerant_a,
                  fmaxf(sigma, 1e-9f)};
  if (family != K5_FAMILY) return static_cast<int>(cudaErrorInvalidValue);
  return launch<K5_FAMILY>(rows, k, prior, n_prior, n_res, state, n_steps,
                           loss, flags, steps_run, stream);
}
