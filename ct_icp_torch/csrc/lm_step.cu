// K5 lm_step: one Levenberg-Marquardt step of the CT-ICP inner loop, with
// all of its state on the device.
//
// Replaces the body of ct_icp_tpu/icp/solver.py:452-534 (_lm_inner_loop)
// for the statics the driving and robust profiles run: CERES, ball
// neighbourhood, point-to-plane, Cauchy loss, CONTINUOUS_TIME, analytic
// Jacobian off (the begin-column freeze of SIMPLE is honoured by a flag).
// The TPU ran the loop as a lax.while_loop inside one XLA program; eager
// PyTorch ran it as ~1,500 small launches and one host read per step. Here a
// step is four launches that read nothing back, so the host enqueues every
// step of the loop at once:
//
//   A (K rows)    residual of each kept row at delta = 0 and its 12 tangents,
//                 by forward mode through apply_delta and the slerp/lerp
//                 transform (the arithmetic of jax.jacfwd, branches of
//                 quat_slerp included: the sign flip, the clip and the nlerp
//                 fallback); the Cauchy IRLS weight; per-block sums of the
//                 78 distinct entries of J^T W J, the 12 of J^T W r and the
//                 cost at delta = 0;
//   B (1 block)   sums the block partials in block order; adds the 10
//                 motion-prior rows and their Jacobian; the degenerate-column
//                 freeze, the Jacobi scaling, the damping and the 12x12 solve
//                 (Gaussian elimination, partial pivoting, float32); the trial
//                 pose apply_delta(delta);
//   C (K rows)    the robust cost of every kept row at the trial pose, summed
//                 per block;
//   D (1 thread)  the trial cost, accept/reject, lambda, cost0, the pose
//                 update and the `done` flag (Ceres' function tolerance).
//
// Every pass returns at once when `done` is set, so steps past convergence
// cost four empty launches. Sums run in a fixed order (warp shuffles, then
// warps, then blocks): no float atomics, so a run repeats bit for bit.
//
// Bound: a step reads each row twice (48 B) and moves a few KB of partials:
// a few hundred KB at K = 4096, about 0.1 us at 3.35 TB/s, and ~2.5 kflop a
// row, ~10 Mflop, about 0.15 us at 67 TFLOP/s. Both are far below the
// launch latency of the four passes; the design's point is the count of
// launches and host reads, not bandwidth.
//
// state (f32[200], see kernels/lm_step.py): 0:14 pose (qb, tb, qe, te),
// 14 lambda, 15 cost0 (NaN until the first step), 16 done, 17 trial cost,
// 18:30 delta, 30:44 trial pose, 44:56 J^T W r, 56:200 J^T W J.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;      // threads per block of passes A and C
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 91;          // 78 of J^T W J, 12 of J^T W r, 1 cost
constexpr int kRow = 12;           // raw 3, alpha, anchor 3, normal 3, w, ok

constexpr int S_LAM = 14, S_COST0 = 15, S_DONE = 16, S_COST1 = 17;
constexpr int S_DELTA = 18, S_TRIAL = 30, S_JTR = 44, S_JTJ = 56;

// ---------------------------------------------------------------- duals —
struct Dual {
  float v, d;
  // every Dual is built with both members set: a value without a tangent
  // is a constant (d = 0)
  __device__ __forceinline__ Dual(float value = 0.0f, float tangent = 0.0f)
      : v(value), d(tangent) {}
};
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return {a.v + b.v, a.d + b.d};
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return {a.v - b.v, a.d - b.d};
}
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  return {a.v / b.v, (a.d - (a.v / b.v) * b.d) / b.v};
}
__device__ __forceinline__ Dual operator-(Dual a, float b) {
  return {a.v - b, a.d};
}
__device__ __forceinline__ Dual operator-(float a, Dual b) {
  return {a - b.v, -b.d};
}
__device__ __forceinline__ Dual operator*(float a, Dual b) {
  return {a * b.v, a * b.d};
}
__device__ __forceinline__ Dual operator*(Dual a, float b) {
  return {a.v * b, a.d * b};
}
__device__ __forceinline__ Dual operator/(Dual a, float b) {
  return {a.v / b, a.d / b};
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }
__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual tsqrt(Dual x) {
  const float s = sqrtf(x.v);
  return {s, x.d / (2.0f * s)};
}
__device__ __forceinline__ float tsin(float x) { return sinf(x); }
__device__ __forceinline__ Dual tsin(Dual x) {
  return {sinf(x.v), cosf(x.v) * x.d};
}
__device__ __forceinline__ float tcos(float x) { return cosf(x); }
__device__ __forceinline__ Dual tcos(Dual x) {
  return {cosf(x.v), -sinf(x.v) * x.d};
}
__device__ __forceinline__ float tacos(float x) { return acosf(x); }
__device__ __forceinline__ Dual tacos(Dual x) {
  return {acosf(x.v), -x.d / sqrtf(1.0f - x.v * x.v)};
}
// clamp_min / clamp_max: the tangent passes where the input is kept
template <class T>
__device__ __forceinline__ T tmax(T a, float lo) {
  return val(a) >= lo ? a : T{lo};
}
template <class T>
__device__ __forceinline__ T tclip(T a, float lo, float hi) {
  if (val(a) < lo) return T{lo};
  if (val(a) > hi) return T{hi};
  return a;
}
__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ Dual tabs(Dual x) { return x.v < 0.0f ? -x : x; }

// ------------------------------------------------- quaternion / SE3 math —
// (w, x, y, z), the formulas of core/math_impl.py in their order
template <class T>
struct Quat {
  T w, x, y, z;
};
template <class T>
struct Vec3 {
  T x, y, z;
};

template <class T>
__device__ __forceinline__ Quat<T> quat_mul(const Quat<T>& p,
                                           const Quat<T>& q) {
  return {p.w * q.w - p.x * q.x - p.y * q.y - p.z * q.z,
          p.w * q.x + p.x * q.w + p.y * q.z - p.z * q.y,
          p.w * q.y - p.x * q.z + p.y * q.w + p.z * q.x,
          p.w * q.z + p.x * q.y - p.y * q.x + p.z * q.w};
}

template <class T>
__device__ __forceinline__ Quat<T> quat_normalize(const Quat<T>& q) {
  const T n = tmax(tsqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z),
                   1e-30f);
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

template <class T>
__device__ __forceinline__ Quat<T> quat_from_rotvec(T rx, T ry, T rz) {
  const T theta2 = rx * rx + ry * ry + rz * rz;
  const T theta = tsqrt(tmax(theta2, 1e-30f));
  const T half = 0.5f * theta;
  const bool small = val(theta2) < 1e-12f;
  const T k = small ? T(0.5f - theta2 / 48.0f) : T(tsin(half) / theta);
  const T w = small ? T(1.0f - theta2 / 8.0f) : T(tcos(half));
  return {w, k * rx, k * ry, k * rz};
}

template <class T>
__device__ __forceinline__ Vec3<T> cross(const Vec3<T>& a, const Vec3<T>& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// quat_rotate(q, v) = v + w t + qv x t, t = 2 qv x v
template <class T>
__device__ __forceinline__ Vec3<T> quat_rotate(const Quat<T>& q,
                                              const Vec3<T>& v) {
  const Vec3<T> qv{q.x, q.y, q.z};
  const Vec3<T> c = cross(qv, v);
  const Vec3<T> t{2.0f * c.x, 2.0f * c.y, 2.0f * c.z};
  const Vec3<T> c2 = cross(qv, t);
  return {v.x + q.w * t.x + c2.x, v.y + q.w * t.y + c2.y,
          v.z + q.w * t.z + c2.z};
}

template <class T>
__device__ __forceinline__ Quat<T> quat_slerp(const Quat<T>& q0, Quat<T> q1,
                                             float t) {
  T d = q0.w * q1.w + q0.x * q1.x + q0.y * q1.y + q0.z * q1.z;
  if (val(d) < 0.0f) q1 = {-q1.w, -q1.x, -q1.y, -q1.z};
  d = tclip(tabs(d), -1.0f, 1.0f);
  const bool near = val(d) > static_cast<float>(1.0 - 1e-7);
  if (near) {
    const float w0 = 1.0f - t, w1 = t;
    return quat_normalize(Quat<T>{w0 * q0.w + w1 * q1.w, w0 * q0.x + w1 * q1.x,
                                  w0 * q0.y + w1 * q1.y,
                                  w0 * q0.z + w1 * q1.z});
  }
  const T theta = tacos(d);
  const T sin_theta = tsin(theta);
  const T w0 = tsin((1.0f - t) * theta) / sin_theta;
  const T w1 = tsin(t * theta) / sin_theta;
  return quat_normalize(Quat<T>{w0 * q0.w + w1 * q1.w, w0 * q0.x + w1 * q1.x,
                                w0 * q0.y + w1 * q1.y, w0 * q0.z + w1 * q1.z});
}

template <class T>
struct Pose {
  Quat<T> qb;
  Vec3<T> tb;
  Quat<T> qe;
  Vec3<T> te;
};

template <class T>
__device__ __forceinline__ Pose<T> pose_from(const float* s) {
  return {{T{s[0]}, T{s[1]}, T{s[2]}, T{s[3]}},
          {T{s[4]}, T{s[5]}, T{s[6]}},
          {T{s[7]}, T{s[8]}, T{s[9]}, T{s[10]}},
          {T{s[11]}, T{s[12]}, T{s[13]}}};
}

// residuals.apply_delta: left-multiplicative so(3) x R^3 perturbation
template <class T>
__device__ __forceinline__ Pose<T> apply_delta(const T* d, const Pose<T>& p) {
  const Quat<T> dqb = quat_from_rotvec(d[0], d[1], d[2]);
  const Quat<T> dqe = quat_from_rotvec(d[6], d[7], d[8]);
  return {quat_normalize(quat_mul(dqb, p.qb)),
          {p.tb.x + d[3], p.tb.y + d[4], p.tb.z + d[5]},
          quat_normalize(quat_mul(dqe, p.qe)),
          {p.te.x + d[9], p.te.y + d[10], p.te.z + d[11]}};
}

// the point-to-plane residual of one row at pose p
template <class T>
__device__ __forceinline__ T plane_residual(const Pose<T>& p,
                                           const float* row) {
  const float a = row[3];
  const Quat<T> qi = quat_slerp(p.qb, p.qe, a);
  const Vec3<T> raw{T{row[0]}, T{row[1]}, T{row[2]}};
  const Vec3<T> rot = quat_rotate(qi, raw);
  const float b = 1.0f - a;
  const Vec3<T> w{rot.x + (b * p.tb.x + a * p.te.x),
                  rot.y + (b * p.tb.y + a * p.te.y),
                  rot.z + (b * p.tb.z + a * p.te.z)};
  const T r = ((w.x - row[4]) * row[7] + (w.y - row[5]) * row[8]) +
              (w.z - row[6]) * row[9];
  return row[10] * r;
}

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------- pass A —
__global__ void lm_pass_a(const float* __restrict__ rows, int k,
                          const float* __restrict__ state, float b,
                          int freeze_begin, float* __restrict__ partials) {
  if (state[S_DONE] != 0.0f) return;
  __shared__ float warp_part[kWarps][kSums];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float jac[12];
  float r = 0.0f, w = 0.0f;
  for (int j = 0; j < 12; ++j) jac[j] = 0.0f;
  if (i < k && rows[kRow * i + 11] != 0.0f) {
    const float* row = rows + kRow * i;
    const Pose<Dual> p0 = pose_from<Dual>(state);
    for (int j = freeze_begin ? 6 : 0; j < 12; ++j) {
      Dual d[12];
      for (int c = 0; c < 12; ++c) d[c] = Dual{0.0f, c == j ? 1.0f : 0.0f};
      const Dual rj = plane_residual(apply_delta(d, p0), row);
      jac[j] = rj.d;
      r = rj.v;
    }
    w = 1.0f / (1.0f + (r * r) / b);
  }
  float jw[12];
  for (int j = 0; j < 12; ++j) jw[j] = jac[j] * w;
  int slot = 0;
  for (int a = 0; a < 12; ++a) {
    for (int c = a; c < 12; ++c) {
      const float s = warp_sum(jw[a] * jac[c]);
      if (lane == 0) warp_part[warp][slot] = s;
      ++slot;
    }
  }
  for (int a = 0; a < 12; ++a) {
    const float s = warp_sum(jw[a] * r);
    if (lane == 0) warp_part[warp][78 + a] = s;
  }
  const float c = warp_sum(cauchy_cost(r * r, b));
  if (lane == 0) warp_part[warp][90] = c;
  __syncthreads();
  for (int v = threadIdx.x; v < kSums; v += kThreads) {
    float s = 0.0f;
    for (int q = 0; q < kWarps; ++q) s += warp_part[q][v];
    partials[blockIdx.x * kSums + v] = s;
  }
}

// ------------------------------------------------------------- pass B —
__device__ void solve12(float a[12][12], float x[12]) {
  for (int col = 0; col < 12; ++col) {
    int piv = col;
    float best = fabsf(a[col][col]);
    for (int r = col + 1; r < 12; ++r) {
      if (fabsf(a[r][col]) > best) {
        best = fabsf(a[r][col]);
        piv = r;
      }
    }
    if (piv != col) {
      for (int c = 0; c < 12; ++c) {
        const float t = a[col][c];
        a[col][c] = a[piv][c];
        a[piv][c] = t;
      }
      const float t = x[col];
      x[col] = x[piv];
      x[piv] = t;
    }
    for (int r = col + 1; r < 12; ++r) {
      const float f = a[r][col] / a[col][col];
      for (int c = col; c < 12; ++c) a[r][c] = a[r][c] - f * a[col][c];
      x[r] = x[r] - f * x[col];
    }
  }
  for (int r = 11; r >= 0; --r) {
    float s = x[r];
    for (int c = r + 1; c < 12; ++c) s = s - a[r][c] * x[c];
    x[r] = s / a[r][r];
  }
}

__global__ void lm_pass_b(const float* __restrict__ partials, int nblocks,
                          const float* __restrict__ prior,
                          const int32_t* __restrict__ n_res, int freeze_begin,
                          float* __restrict__ state) {
  if (state[S_DONE] != 0.0f) return;
  __shared__ float sums[kSums];
  for (int v = threadIdx.x; v < kSums; v += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < nblocks; ++q) s += partials[q * kSums + v];
    sums[v] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const float n = fmaxf(static_cast<float>(*n_res), 0.0f);
  const Pose<Dual> p0 = pose_from<Dual>(state);
  float pj[10][12];
  float pr[10];
  for (int j = 0; j < 12; ++j) {
    Dual d[12];
    for (int c = 0; c < 12; ++c) d[c] = Dual{0.0f, c == j ? 1.0f : 0.0f};
    Dual rr[10];
    prior_residuals(apply_delta(d, p0), prior, n, rr);
    for (int q = 0; q < 10; ++q) {
      pj[q][j] = (freeze_begin && j < 6) ? 0.0f : rr[q].d;
      pr[q] = rr[q].v;
    }
  }
  float jtj[12][12], jtr[12];
  int slot = 0;
  for (int a = 0; a < 12; ++a) {
    for (int c = a; c < 12; ++c) {
      float s = sums[slot++];
      for (int q = 0; q < 10; ++q) s += pj[q][a] * pj[q][c];
      jtj[a][c] = s;
      jtj[c][a] = s;
    }
  }
  float prior_cost = 0.0f;
  for (int q = 0; q < 10; ++q) prior_cost += pr[q] * pr[q];
  for (int a = 0; a < 12; ++a) {
    float s = sums[78 + a];
    for (int q = 0; q < 10; ++q) s += pj[q][a] * pr[q];
    jtr[a] = s;
  }
  if (isnan(state[S_COST0])) state[S_COST0] = sums[90] + prior_cost;
  for (int a = 0; a < 12; ++a) {
    state[S_JTR + a] = jtr[a];
    for (int c = 0; c < 12; ++c) state[S_JTJ + 12 * a + c] = jtj[a][c];
  }

  // degenerate-column freeze, Jacobi scaling, damping (solver.py:499-518)
  float maxd = jtj[0][0];
  for (int a = 1; a < 12; ++a) maxd = fmaxf(maxd, jtj[a][a]);
  const float thr = 1e-7f * fmaxf(maxd, 1e-12f);
  bool degen[12];
  float dsc[12], keep[12];
  for (int a = 0; a < 12; ++a) {
    degen[a] = jtj[a][a] <= thr;
    keep[a] = degen[a] ? 0.0f : 1.0f;
    dsc[a] = degen[a] ? 1.0f : sqrtf(fmaxf(jtj[a][a], 1e-20f));
  }
  const float lam = state[S_LAM];
  float m[12][12], x[12];
  for (int a = 0; a < 12; ++a) {
    for (int c = 0; c < 12; ++c) {
      float v = jtj[a][c] / (dsc[a] * dsc[c]);
      v = v * keep[a] * keep[c];
      if (a == c && degen[a]) v = v + 1.0f;
      m[a][c] = v;
    }
  }
  for (int a = 0; a < 12; ++a) m[a][a] = (m[a][a] + lam * m[a][a]) + 1e-7f;
  for (int a = 0; a < 12; ++a) x[a] = -jtr[a] / dsc[a] * keep[a];
  solve12(m, x);
  float delta[12];
  for (int a = 0; a < 12; ++a) {
    delta[a] = x[a] / dsc[a] * keep[a];
    state[S_DELTA + a] = delta[a];
  }
  const Pose<float> trial = apply_delta(delta, pose_from<float>(state));
  const float tp[14] = {trial.qb.w, trial.qb.x, trial.qb.y, trial.qb.z,
                        trial.tb.x, trial.tb.y, trial.tb.z,
                        trial.qe.w, trial.qe.x, trial.qe.y, trial.qe.z,
                        trial.te.x, trial.te.y, trial.te.z};
  for (int a = 0; a < 14; ++a) state[S_TRIAL + a] = tp[a];
}

// ------------------------------------------------------------- pass C —
__global__ void lm_pass_c(const float* __restrict__ rows, int k,
                          const float* __restrict__ state, float b,
                          float* __restrict__ partials) {
  if (state[S_DONE] != 0.0f) return;
  __shared__ float warp_part[kWarps];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float c = 0.0f;
  if (i < k && rows[kRow * i + 11] != 0.0f) {
    const float r = plane_residual(pose_from<float>(state + S_TRIAL),
                                   rows + kRow * i);
    c = cauchy_cost(r * r, b);
  }
  c = warp_sum(c);
  if (lane == 0) warp_part[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int q = 0; q < kWarps; ++q) s += warp_part[q];
    partials[blockIdx.x] = s;
  }
}

// ------------------------------------------------------------- pass D —
__global__ void lm_pass_d(const float* __restrict__ partials, int nblocks,
                          const float* __restrict__ prior,
                          const int32_t* __restrict__ n_res,
                          float* __restrict__ state) {
  if (state[S_DONE] != 0.0f) return;
  float c_pts = 0.0f;
  for (int q = 0; q < nblocks; ++q) c_pts += partials[q];
  const Pose<float> trial = pose_from<float>(state + S_TRIAL);
  float pr[10];
  prior_residuals(trial, prior, fmaxf(static_cast<float>(*n_res), 0.0f), pr);
  float prior_cost = 0.0f;
  for (int q = 0; q < 10; ++q) prior_cost += pr[q] * pr[q];
  const float cost1 = c_pts + prior_cost;
  const float cost0 = state[S_COST0];
  const bool accept = cost1 < cost0;
  const bool done = accept && (cost0 - cost1 <= 1e-6f * (cost0 + 1e-30f));
  state[S_COST1] = cost1;
  if (accept) {
    for (int a = 0; a < 14; ++a) state[a] = state[S_TRIAL + a];
  } else {
    // apply_delta(0): the translations stay, the quaternions renormalise
    const float zero[12] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f,
                            0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const Pose<float> same = apply_delta(zero, pose_from<float>(state));
    state[0] = same.qb.w;
    state[1] = same.qb.x;
    state[2] = same.qb.y;
    state[3] = same.qb.z;
    state[7] = same.qe.w;
    state[8] = same.qe.x;
    state[9] = same.qe.y;
    state[10] = same.qe.z;
  }
  const float lam = state[S_LAM];
  state[S_LAM] = accept ? fmaxf(lam / 3.0f, 1e-8f) : fminf(lam * 4.0f, 1e4f);
  state[S_COST0] = accept ? cost1 : cost0;
  state[S_DONE] = done ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int k5_lm_step(const void* rows, int k, const void* prior,
                          const void* n_res, void* state, float sigma,
                          int freeze_begin, void* partials_a,
                          void* partials_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = k > 0 ? (k + kThreads - 1) / kThreads : 1;
  const float b = sigma * sigma;
  auto* st = static_cast<float*>(state);
  auto* pa = static_cast<float*>(partials_a);
  auto* pc = static_cast<float*>(partials_c);
  const auto* rw = static_cast<const float*>(rows);
  const auto* pri = static_cast<const float*>(prior);
  const auto* nr = static_cast<const int32_t*>(n_res);
  lm_pass_a<<<nb, kThreads, 0, s>>>(rw, k, st, b, freeze_begin, pa);
  lm_pass_b<<<1, kThreads, 0, s>>>(pa, nb, pri, nr, freeze_begin, st);
  lm_pass_c<<<nb, kThreads, 0, s>>>(rw, k, st, b, pc);
  lm_pass_d<<<1, 1, 0, s>>>(pc, nb, pri, nr, st);
  return static_cast<int>(cudaGetLastError());
}
