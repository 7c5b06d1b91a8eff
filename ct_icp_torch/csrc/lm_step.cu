// K5 lm_step: the Levenberg-Marquardt inner loop of CT-ICP, every step of
// one LM call in one launch, its state on the device.
//
// Replaces ct_icp_tpu/icp/solver.py:418-539 (_lm_inner_loop) for the
// statics the driving and robust profiles run: CERES, ball neighbourhood,
// point-to-plane, Cauchy loss, CONTINUOUS_TIME, analytic Jacobian off (the
// begin-column freeze of SIMPLE is honoured by a flag). The reference runs
// the loop as a lax.while_loop (it < n and ~done) inside one XLA program.
// Here one launch of a thread-block cluster of 16 CTAs runs it (a
// non-portable size, which the H100 schedules; a card that refuses it fails
// the launch). Each CTA keeps its share of the rows in shared memory for
// the whole call (rows beyond what the cluster holds are read from global
// memory, where they stay in L2).
// A step:
//
//   1. rows: the residual of each kept row at delta = 0 and its 12 tangents
//      by forward mode (the arithmetic of jax.jacfwd, branches of
//      quat_slerp included: the sign flip, the clip and the nlerp
//      fallback), in two passes of 6 tangents (begin, end) through the
//      pose's own tangents and slerp setup, which a thread a column
//      computes at the start of the step (and another warp the prior
//      rows' Jacobian);
//      the Cauchy IRLS weight; per chunk of 256 rows, the 78 sums of
//      J^T W J, the 12 of J^T W r and the cost, each by one warp;
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
// bit, and every CTA computes the same solve from the same sums.
//
// Bound: the rows are read once a call (48 B a row); a step is ~1,100 float
// operations a kept row (3.2 Mflop at K = 2,941: 0.05 us at 67 TFLOP/s). The
// loop is bound by its serial chain, not by bytes or operations: the two
// cluster barriers, the pose-level work and the solve of every step.
//
// state (f32[200], see kernels/lm_step.py): 0:14 pose (qb, tb, qe, te),
// 14 lambda, 15 cost0 (NaN until the first step), 16 done, 17 trial cost,
// 18:30 delta, 30:44 trial pose, 44:56 J^T W r, 56:200 J^T W J; after the
// call, 17:200 hold the last step's values.
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
constexpr int kRow = 12;             // raw 3, alpha, anchor 3, normal 3, w, ok
constexpr int kStateSize = 200;
constexpr int kChunkStride = 15;     // jac 12, r, w (odd: no bank conflicts)
constexpr int kRowsOnChip = 4096;    // rows a CTA keeps in shared memory
#ifndef K5_CLUSTER
#define K5_CLUSTER 16
#endif
constexpr int kCluster = K5_CLUSTER; // CTAs of the launch
static_assert(kCluster >= 1 && kCluster <= 16, "a cluster is 1..16 CTAs");

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

__device__ __forceinline__ float cauchy_cost(float r2, float b) {
  return b * log1pf(r2 / b);
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
  float pj[10][12];              // the prior's Jacobian
  float pr[12];                  // the prior's residuals
  unsigned char pair[78][2];     // (a, c) of each J^T W J sum
  Pose<Dual6> pose_d[2];         // the pose's begin / end tangents
  Slerp<Dual6> slerp_d[2];
  Pose<float> trial;
  Slerp<float> slerp_trial;
  Pose<float> same;              // the pose a rejected step keeps
  float trial_prior_cost;
};
constexpr int kFixedBytes =
    (static_cast<int>(sizeof(Shared)) + 15) / 16 * 16 +
    kThreads * kChunkStride * 4;
static_assert(kFixedBytes + kRowsOnChip * kRow * 4 <= 232448,
              "a CTA's shared memory is 227 KB");

// ------------------------------------------------------------- the loop —
__global__ void __launch_bounds__(kThreads, 1)
    lm_loop_kernel(const float* __restrict__ rows, int k, int rows_per_cta,
                   int on_chip, const float* __restrict__ prior,
                   const int32_t* __restrict__ n_res, float* state,
                   int n_steps, float b, int freeze_begin,
                   int32_t* steps_run) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 dyn[];
  Shared& sm = *reinterpret_cast<Shared*>(dyn);
  float* chunk = reinterpret_cast<float*>(reinterpret_cast<char*>(dyn) +
                                          (sizeof(Shared) + 15) / 16 * 16);
  float* srows = chunk + kThreads * kChunkStride;
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
        Dual1 rr[10];
        prior_residuals(pd, prior, n, rr);
#pragma unroll
        for (int q = 0; q < 10; ++q) {
          sm.pj[q][j] = (freeze_begin && j < 6) ? 0.0f : rr[q].d[0];
          if (j == 0) sm.pr[q] = rr[q].v;
        }
      }
    }
    for (int s = tid; s < kSums; s += kThreads) sm.part_a[s] = 0.0f;
    __syncthreads();
    MARK(0);

    // ---- 1. rows: residual, Jacobian, weight; sums chunk by chunk
    for (int base = 0; base < nrows; base += kThreads) {
      const int i = base + tid;
      float jac[12], r = 0.0f, w = 0.0f;
#pragma unroll
      for (int j = 0; j < 12; ++j) jac[j] = 0.0f;
      if (i < nrows && my_rows[kRow * i + 11] != 0.0f) {
        const float* row = my_rows + kRow * i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 0 && freeze_begin) continue;
          const Dual6 rj = plane_residual(sm.pose_d[h], sm.slerp_d[h], row);
#pragma unroll
          for (int j = 0; j < kTan; ++j) jac[kTan * h + j] = rj.d[j];
          r = rj.v;
        }
        w = 1.0f / (1.0f + (r * r) / b);
      }
      float* mine = chunk + tid * kChunkStride;
#pragma unroll
      for (int j = 0; j < 12; ++j) mine[j] = jac[j];
      mine[12] = r;
      mine[13] = w;
      __syncthreads();
      const int len = min(kThreads, nrows - base);
      for (int s = warp; s < kSums; s += kWarps) {
        float acc = 0.0f;
        if (s < 78) {
          const int a = sm.pair[s][0], c = sm.pair[s][1];
          for (int q = lane; q < len; q += 32) {
            const float* cq = chunk + q * kChunkStride;
            acc += (cq[a] * cq[13]) * cq[c];
          }
        } else if (s < 90) {
          for (int q = lane; q < len; q += 32) {
            const float* cq = chunk + q * kChunkStride;
            acc += (cq[s - 78] * cq[13]) * cq[12];
          }
        } else {
          for (int q = lane; q < len; q += 32) {
            const float* cq = chunk + q * kChunkStride;
            acc += cauchy_cost(cq[12] * cq[12], b);
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
      sm.state[S_JTJ + 12 * a + c] = s;
      sm.state[S_JTJ + 12 * c + a] = s;
    } else if (tid < 90) {
      const int a = tid - 78;
      float s = sm.sums[tid];
#pragma unroll
      for (int q = 0; q < 10; ++q) s += sm.pj[q][a] * sm.pr[q];
      sm.state[S_JTR + a] = s;
    } else if (tid == 90) {
      float prior_cost = 0.0f;
#pragma unroll
      for (int q = 0; q < 10; ++q) prior_cost += sm.pr[q] * sm.pr[q];
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
      float pr[10];
      prior_residuals(sm.trial, prior, n, pr);
      float prior_cost = 0.0f;
      for (int q = 0; q < 10; ++q) prior_cost += pr[q] * pr[q];
      sm.trial_prior_cost = prior_cost;
      const float zero[12] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f,
                              0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      sm.same = apply_delta(zero, pose_from<float>(sm.state));
    }
    float cost = 0.0f;
    for (int i = tid; i < nrows; i += kThreads) {
      if (my_rows[kRow * i + 11] != 0.0f) {
        const float r = plane_residual(sm.trial, sm.slerp_trial,
                                       my_rows + kRow * i);
        cost += cauchy_cost(r * r, b);
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

// The shared-memory and non-portable-cluster attributes, once a process.
int setup() {
  static bool done = false;
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      lm_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFixedBytes + kRowsOnChip * kRow * 4);
  if (e == cudaSuccess && kCluster > 8)
    e = cudaFuncSetAttribute(lm_loop_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

}  // namespace

// The rows the cluster keeps on chip (beyond them the rows are read from
// global memory).
extern "C" int k5_rows_on_chip() { return kCluster * kRowsOnChip; }

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
// steps_run (int32 [1]).
extern "C" int k5_lm_loop(const void* rows, int k, const void* prior,
                          const void* n_res, void* state, int n_steps,
                          float sigma, int freeze_begin, void* steps_run,
                          void* stream) {
  const int err = setup();
  if (err != 0) return err;
  const int per_cta = k > 0 ? (k + kCluster - 1) / kCluster : 0;
  const int on_chip = per_cta <= kRowsOnChip ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kFixedBytes + (on_chip ? per_cta * kRow * 4 : 0);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, lm_loop_kernel, static_cast<const float*>(rows), k, per_cta,
      on_chip, static_cast<const float*>(prior),
      static_cast<const int32_t*>(n_res), static_cast<float*>(state), n_steps,
      sigma * sigma, freeze_begin, static_cast<int32_t*>(steps_run));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
