// K8 ct_ba_block: one inner iteration of the CT-BA block-Jacobi step (every
// keyframe's damped 12x12 Gauss-Newton update), or the point + prior blocks
// the coupled (PCG) step assembles, in one launch.
//
// Replaces ct_icp_tpu/parallel/ct_ba.py:120-152 (_frame_gn_update, vmapped
// over the keyframes by local_step, :228-278) and :170-198 (_frame_blocks,
// local_step_pcg's row pass). The reference forms each keyframe's normal
// equations by jax.jacfwd over K point rows, 8 continuity rows and 8 prior
// rows; here the rows carry 12 forward-mode tangents as dual numbers
// (dual.cuh, the rules K5 uses, so each tangent follows jax.jacfwd's
// arithmetic: quat_slerp's sign flip, clip and nlerp fallback included).
//
// Grid: (splits, F). The K point rows of keyframe f are split over
// `splits` CTAs of 256 threads, a row a thread (8 CTAs for a window of 8
// would leave most of the card idle). Each CTA:
//   1. twelve threads, a column each, take the frame's pose tangents and
//      its slerp setup (the previous iterate's pose, poses_in) into shared
//      memory as 6-tangent duals;
//   2. each thread evaluates its row's residual and 12 tangents in two
//      passes of 6 (begin, end); the 78 sums of J^T J, the 12 of J^T r and
//      the sum of r^2 over the CTA's rows, each by one warp in row order,
//      go to its slot of `partial`;
//   3. the last CTA of the frame to finish (an integer counter a frame, no
//      float atomics: the partials are summed in CTA order, so a run
//      repeats bit for bit) adds the 16 pose-level rows (a thread a column:
//      continuity against the neighbours' previous iterate, the
//      predecessor's pose extrapolated to the frame's begin timestamp;
//      prior rows against the assembly-time pose), writes J^T J, J^T r and
//      the cost, and in mode 0 ("gn") solves the Jacobi-scaled damped
//      system on one warp and writes the updated pose to poses_out.
// Mode 1 ("blocks") leaves the continuity rows out (the coupled solver's
// edges stay in torch) and solves nothing. A row of weight 0 is skipped:
// the reference's row is exactly 0 there (0 times a finite residual).
//
// Bound: bytes (44 B a row read once, the poses, priors and outputs), or
// operations (850-1,000 float operations a row: the residual, 12 tangents
// and the 91 products and sums), whichever is longer: ~0.4-0.5 us for
// F = 8, K = 4,096. The launch is bound by its serial chain: the tangent
// setup, one pass over a row, the cross-CTA handoff and the finisher's
// solve.
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "dual.cuh"

namespace {

using namespace cticp;

constexpr int kThreads = 256;        // threads per CTA, a row each
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 91;            // 78 of J^T J, 12 of J^T r, 1 r^2
constexpr int kChunkStride = 13;     // jac 12, r (odd: no bank conflicts)
constexpr int kPoseRows = 16;        // 8 continuity, 8 prior

struct Shared {
  float sums[kSums + 1];
  float jtj[144];
  float jtr[12];
  float pj[kPoseRows][12];           // the pose-level rows' Jacobian
  float pr[kPoseRows];               // and their residuals
  unsigned char pair[78][2];         // (a, c) of each J^T J sum
  Pose<Dual6> pose_d[2];             // the pose's begin / end tangents
  Slerp<Dual6> slerp_d[2];
  int last;
};

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

// The 16 pose-level rows of frame f at its perturbed pose p (continuity:
// against the predecessor's extrapolation (qp, tp) and the successor's
// begin pose (qn, tn), zero weights at the window's ends; prior: against
// the assembly-time pose pair)
template <class T>
__device__ __forceinline__ void pose_rows(
    const Pose<T>& p, const float* qp, const float* tp, const float* qn,
    const float* tn, float w_prev, float w_next, float beta, float ea,
    const float* pqb, const float* ptb, const float* pqe, const float* pte,
    float pw, T* r) {
  const float bp = beta * w_prev, bn = beta * w_next;
  r[0] = bp * (p.tb.x - tp[0]);
  r[1] = bp * (p.tb.y - tp[1]);
  r[2] = bp * (p.tb.z - tp[2]);
  const T dp = quat_dot(quat_normalize(p.qb), qp);
  r[3] = bp * (1.0f - dp * dp);
  Quat<T> qx;
  Vec3<T> tx;
  pose_at(p, ea, qx, tx);
  r[4] = bn * (tx.x - tn[0]);
  r[5] = bn * (tx.y - tn[1]);
  r[6] = bn * (tx.z - tn[2]);
  const T dn = quat_dot(quat_normalize(qx), qn);
  r[7] = bn * (1.0f - dn * dn);
  r[8] = pw * (p.tb.x - ptb[0]);
  r[9] = pw * (p.tb.y - ptb[1]);
  r[10] = pw * (p.tb.z - ptb[2]);
  const T db = quat_dot(quat_normalize(p.qb), pqb);
  r[11] = pw * (1.0f - db * db);
  r[12] = pw * (p.te.x - pte[0]);
  r[13] = pw * (p.te.y - pte[1]);
  r[14] = pw * (p.te.z - pte[2]);
  const T de = quat_dot(quat_normalize(p.qe), pqe);
  r[15] = pw * (1.0f - de * de);
}

__global__ void __launch_bounds__(kThreads)
    ct_ba_block_kernel(const float* __restrict__ poses_in,
                       float* __restrict__ poses_out,
                       const float* __restrict__ raw,
                       const float* __restrict__ alphas,
                       const float* __restrict__ anchors,
                       const float* __restrict__ normals,
                       const float* __restrict__ weights,
                       const float* __restrict__ pqb,
                       const float* __restrict__ ptb,
                       const float* __restrict__ pqe,
                       const float* __restrict__ pte,
                       const float* __restrict__ prior_weight,
                       const float* __restrict__ edge_alpha, int nf, int k,
                       float beta, float damping, int mode,
                       float* __restrict__ partial, int* counters,
                       float* __restrict__ cost, float* __restrict__ jtj_out,
                       float* __restrict__ jtr_out) {
  __shared__ Shared sm;
  __shared__ float chunk[kThreads * kChunkStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = blockIdx.y, split = blockIdx.x, splits = gridDim.x;
  const float* pose = poses_in + 14 * f;

  // ---- 1. a thread a column: the pose's tangents and the slerp setup's
  if (warp == 0 && lane < 12) {
    const int j = lane;
    Dual1 d[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      d[c] = Dual1{0.0f};
      if (c == j) d[c].d[0] = 1.0f;
    }
    const Pose<Dual1> pd = apply_delta(d, pose_from<Dual1>(pose));
    const Slerp<Dual1> sl = slerp_setup(pd.qb, pd.qe);
    scatter_tangent(pd, sm.pose_d[j / kTan], j % kTan, 14);
    scatter_tangent(sl, sm.slerp_d[j / kTan], j % kTan, 10);
    if (j % kTan == 0) sm.slerp_d[j / kTan].near = sl.near;
  }
  if (tid < 78) {
    int a = 0, s = tid;
    while (s >= 12 - a) s -= 12 - a++;
    sm.pair[tid][0] = static_cast<unsigned char>(a);
    sm.pair[tid][1] = static_cast<unsigned char>(a + s);
  }
  __syncthreads();

  // ---- 2. this CTA's rows: residual and 12 tangents, then the sums
  {
    const int i = split * kThreads + tid;
    float jac[12], r = 0.0f;
#pragma unroll
    for (int j = 0; j < 12; ++j) jac[j] = 0.0f;
    const size_t fi = static_cast<size_t>(f) * k + i;
    if (i < k && weights[fi] != 0.0f) {
      const float row[11] = {
          raw[3 * fi], raw[3 * fi + 1], raw[3 * fi + 2], alphas[fi],
          anchors[3 * fi], anchors[3 * fi + 1], anchors[3 * fi + 2],
          normals[3 * fi], normals[3 * fi + 1], normals[3 * fi + 2],
          weights[fi]};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Dual6 rj = plane_residual(sm.pose_d[h], sm.slerp_d[h], row);
#pragma unroll
        for (int j = 0; j < kTan; ++j) jac[kTan * h + j] = rj.d[j];
        r = rj.v;
      }
    }
    float* mine = chunk + tid * kChunkStride;
#pragma unroll
    for (int j = 0; j < 12; ++j) mine[j] = jac[j];
    mine[12] = r;
  }
  __syncthreads();
  {
    const int len = min(kThreads, k - split * kThreads);
    float* out = partial + (static_cast<size_t>(f) * splits + split) * kSums;
    for (int s = warp; s < kSums; s += kWarps) {
      int a = 12, c = 12;                 // s == 90: r * r
      if (s < 78) {
        a = sm.pair[s][0];
        c = sm.pair[s][1];
      } else if (s < 90) {
        a = s - 78;
      }
      float acc = 0.0f;
      for (int q = lane; q < len; q += 32) {
        const float* cq = chunk + q * kChunkStride;
        acc += cq[a] * cq[c];
      }
      acc = warp_sum(acc);
      if (lane == 0) out[s] = acc;
    }
  }
  // every thread's partial writes are visible before the frame's counter
  // moves; the last CTA of the frame goes on
  __threadfence();
  __syncthreads();
  if (tid == 0) sm.last = atomicAdd(counters + f, 1) == splits - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();

  // ---- 3. the frame's finisher: the CTAs' sums in CTA order
  if (tid < kSums) {
    float s = 0.0f;
    for (int q = 0; q < splits; ++q)
      s += __ldcg(partial + (static_cast<size_t>(f) * splits + q) * kSums +
                  tid);
    sm.sums[tid] = s;
  }
  if (tid == 0) counters[f] = 0;     // ready for the next launch
  // the pose-level rows, a thread a column
  if (warp == 1 && lane < 12) {
    const int j = lane;
    Dual1 d[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      d[c] = Dual1{0.0f};
      if (c == j) d[c].d[0] = 1.0f;
    }
    const Pose<Dual1> pd = apply_delta(d, pose_from<Dual1>(pose));
    // the neighbours at the previous iterate: the predecessor's pose
    // extrapolated to this frame's begin timestamp and the successor's
    // begin pose; the window's ends wrap (as the reference's one-shard
    // halo does) and meet a zero weight
    const int fp = f == 0 ? nf - 1 : f - 1;
    const int fn = f == nf - 1 ? 0 : f + 1;
    Quat<float> qp;
    Vec3<float> tp;
    pose_at(pose_from<float>(poses_in + 14 * fp), edge_alpha[fp], qp, tp);
    const float qpa[4] = {qp.w, qp.x, qp.y, qp.z};
    const float tpa[3] = {tp.x, tp.y, tp.z};
    const float* next = poses_in + 14 * fn;
    const float w_prev = (mode == 0 && f > 0) ? 1.0f : 0.0f;
    const float w_next = (mode == 0 && f < nf - 1) ? 1.0f : 0.0f;
    Dual1 rr[kPoseRows];
    pose_rows(pd, qpa, tpa, next, next + 4, w_prev, w_next, beta,
              edge_alpha[f], pqb + 4 * f, ptb + 3 * f, pqe + 4 * f,
              pte + 3 * f, prior_weight[f], rr);
#pragma unroll
    for (int q = 0; q < kPoseRows; ++q) {
      sm.pj[q][j] = rr[q].d[0];
      if (j == 0) sm.pr[q] = rr[q].v;
    }
  }
  __syncthreads();
  // in mode 1 the continuity rows are not part of the blocks
  const int q0 = mode == 0 ? 0 : 8;
  if (tid < 78) {
    const int a = sm.pair[tid][0], c = sm.pair[tid][1];
    float s = sm.sums[tid];
    for (int q = q0; q < kPoseRows; ++q) s += sm.pj[q][a] * sm.pj[q][c];
    sm.jtj[12 * a + c] = s;
    sm.jtj[12 * c + a] = s;
  } else if (tid < 90) {
    const int a = tid - 78;
    float s = sm.sums[tid];
    for (int q = q0; q < kPoseRows; ++q) s += sm.pj[q][a] * sm.pr[q];
    sm.jtr[a] = s;
  } else if (tid == 90) {
    float cont = 0.0f, pri = 0.0f;
    for (int q = 0; q < 8; ++q) cont += sm.pr[q] * sm.pr[q];
    for (int q = 8; q < kPoseRows; ++q) pri += sm.pr[q] * sm.pr[q];
    // each interior edge appears in both of its frames' rows: halved
    cost[f] = mode == 0 ? (sm.sums[90] + 0.5f * cont) + pri
                        : sm.sums[90] + pri;
  }
  __syncthreads();
  for (int v = tid; v < 144; v += kThreads) jtj_out[144 * f + v] = sm.jtj[v];
  if (tid < 12) jtr_out[12 * f + tid] = sm.jtr[tid];
  if (mode != 0 || warp != 0) return;

  // ---- the Jacobi-scaled damped solve (one warp, a lane a row), the
  // update of the pose
  float dsc[12];
#pragma unroll
  for (int c = 0; c < 12; ++c)
    dsc[c] = sqrtf(fmaxf(sm.jtj[13 * c], 1e-12f));
  const int a = lane < 12 ? lane : 0;
  float da = 1.0f;
#pragma unroll
  for (int c = 0; c < 12; ++c)
    if (c == a) da = dsc[c];
  float m[12], xs[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    float v = sm.jtj[12 * a + c] / (da * dsc[c]);
    if (c == a) v = v + damping;
    m[c] = lane < 12 ? v : 0.0f;
  }
  const float x = lane < 12 ? -sm.jtr[a] / da : 0.0f;
  solve12_warp(m, x, xs);
  if (lane == 0) {
    float delta[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) delta[c] = xs[c] / dsc[c];
    const Pose<float> np = apply_delta(delta, pose_from<float>(pose));
    float* o = poses_out + 14 * f;
    o[0] = np.qb.w;
    o[1] = np.qb.x;
    o[2] = np.qb.y;
    o[3] = np.qb.z;
    o[4] = np.tb.x;
    o[5] = np.tb.y;
    o[6] = np.tb.z;
    o[7] = np.qe.w;
    o[8] = np.qe.x;
    o[9] = np.qe.y;
    o[10] = np.qe.z;
    o[11] = np.te.x;
    o[12] = np.te.y;
    o[13] = np.te.z;
  }
}

}  // namespace

// The CTAs a frame's K rows take (the partial buffer holds F x splits x 91
// floats).
extern "C" int k8_splits(int k) {
  return k > 0 ? (k + kThreads - 1) / kThreads : 1;
}

// One launch: mode 0 one block-Jacobi inner iteration (poses_out, cost,
// J^T J, J^T r), mode 1 the point + prior blocks (cost, J^T J, J^T r).
// counters (int32 [F]) must be zero; the launch leaves them zero.
extern "C" int k8_ct_ba_block(
    const void* poses_in, void* poses_out, const void* raw,
    const void* alphas, const void* anchors, const void* normals,
    const void* weights, const void* pqb, const void* ptb, const void* pqe,
    const void* pte, const void* prior_weight, const void* edge_alpha,
    int nf, int k, int splits, float beta, float damping, int mode,
    void* partial, void* counters, void* cost, void* jtj, void* jtr,
    void* stream) {
  if (nf < 1 || nf > 65535 || k < 0 || splits != k8_splits(k) ||
      (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  ct_ba_block_kernel<<<dim3(splits, nf), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(poses_in), static_cast<float*>(poses_out),
      static_cast<const float*>(raw), static_cast<const float*>(alphas),
      static_cast<const float*>(anchors), static_cast<const float*>(normals),
      static_cast<const float*>(weights), static_cast<const float*>(pqb),
      static_cast<const float*>(ptb), static_cast<const float*>(pqe),
      static_cast<const float*>(pte),
      static_cast<const float*>(prior_weight),
      static_cast<const float*>(edge_alpha), nf, k, beta, damping, mode,
      static_cast<float*>(partial), static_cast<int*>(counters),
      static_cast<float*>(cost), static_cast<float*>(jtj),
      static_cast<float*>(jtr));
  return static_cast<int>(cudaGetLastError());
}
