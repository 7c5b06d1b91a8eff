// Shared device code of the kernels that evaluate CT-ICP residuals and
// their Jacobian by forward mode (K5 lm_step, K8 ct_ba_block): dual
// numbers, the quaternion / SE3 formulas of core/math_impl.py in their
// order, the left-multiplicative pose perturbation, the point-to-plane row,
// the scatter of per-column tangents into a pose's 6-tangent duals, a warp
// sum and one warp's 12x12 solve. Everything is __forceinline__: a kernel
// that includes it compiles as if the code were its own.
#pragma once
#include <cmath>
#include <cstddef>

#include <cuda_runtime.h>

namespace cticp {

constexpr int kTan = 6;              // tangents a row pass carries

// ---------------------------------------------------------------- duals —
// A value and N tangents. Every tangent follows its own rule from the
// values alone, so a dual of N tangents gives each tangent bit for bit what
// a dual of one would.
template <int N>
struct DualT {
  float v;
  float d[N];
  DualT() = default;
  // a value without tangents is a constant (every d = 0)
  __device__ __forceinline__ DualT(float value) : v(value) {
#pragma unroll
    for (int j = 0; j < N; ++j) d[j] = 0.0f;
  }
};
using Dual1 = DualT<1>;
using Dual6 = DualT<kTan>;

#define DUAL_OP(expr_v, expr_d)                     \
  DualT<N> r(expr_v);                               \
  for (int j = 0; j < N; ++j) r.d[j] = (expr_d);    \
  return r;

template <int N>
__device__ __forceinline__ DualT<N> operator+(const DualT<N>& a,
                                              const DualT<N>& b) {
  DUAL_OP(a.v + b.v, a.d[j] + b.d[j])
}
template <int N>
__device__ __forceinline__ DualT<N> operator-(const DualT<N>& a,
                                              const DualT<N>& b) {
  DUAL_OP(a.v - b.v, a.d[j] - b.d[j])
}
template <int N>
__device__ __forceinline__ DualT<N> operator-(const DualT<N>& a) {
  DUAL_OP(-a.v, -a.d[j])
}
template <int N>
__device__ __forceinline__ DualT<N> operator*(const DualT<N>& a,
                                              const DualT<N>& b) {
  DUAL_OP(a.v * b.v, a.d[j] * b.v + a.v * b.d[j])
}
template <int N>
__device__ __forceinline__ DualT<N> operator/(const DualT<N>& a,
                                              const DualT<N>& b) {
  const float q = a.v / b.v;
  DUAL_OP(q, (a.d[j] - q * b.d[j]) / b.v)
}
template <int N>
__device__ __forceinline__ DualT<N> operator-(const DualT<N>& a, float b) {
  DUAL_OP(a.v - b, a.d[j])
}
template <int N>
__device__ __forceinline__ DualT<N> operator-(float a, const DualT<N>& b) {
  DUAL_OP(a - b.v, -b.d[j])
}
template <int N>
__device__ __forceinline__ DualT<N> operator*(float a, const DualT<N>& b) {
  DUAL_OP(a * b.v, a * b.d[j])
}
template <int N>
__device__ __forceinline__ DualT<N> operator*(const DualT<N>& a, float b) {
  DUAL_OP(a.v * b, a.d[j] * b)
}
template <int N>
__device__ __forceinline__ DualT<N> operator/(const DualT<N>& a, float b) {
  DUAL_OP(a.v / b, a.d[j] / b)
}

__device__ __forceinline__ float val(float x) { return x; }
template <int N>
__device__ __forceinline__ float val(const DualT<N>& x) { return x.v; }
__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
template <int N>
__device__ __forceinline__ DualT<N> tsqrt(const DualT<N>& x) {
  const float s = sqrtf(x.v);
  DUAL_OP(s, x.d[j] / (2.0f * s))
}
__device__ __forceinline__ float tsin(float x) { return sinf(x); }
template <int N>
__device__ __forceinline__ DualT<N> tsin(const DualT<N>& x) {
  const float c = cosf(x.v);
  DUAL_OP(sinf(x.v), c * x.d[j])
}
__device__ __forceinline__ float tcos(float x) { return cosf(x); }
template <int N>
__device__ __forceinline__ DualT<N> tcos(const DualT<N>& x) {
  const float s = -sinf(x.v);
  DUAL_OP(cosf(x.v), s * x.d[j])
}
__device__ __forceinline__ float tacos(float x) { return acosf(x); }
template <int N>
__device__ __forceinline__ DualT<N> tacos(const DualT<N>& x) {
  const float s = sqrtf(1.0f - x.v * x.v);
  DUAL_OP(acosf(x.v), -x.d[j] / s)
}
#undef DUAL_OP
// clamp_min / clamp_max: the tangent passes where the input is kept
template <class T>
__device__ __forceinline__ T tmax(const T& a, float lo) {
  return val(a) >= lo ? a : T{lo};
}
template <class T>
__device__ __forceinline__ T tclip(const T& a, float lo, float hi) {
  if (val(a) < lo) return T{lo};
  if (val(a) > hi) return T{hi};
  return a;
}
__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
template <int N>
__device__ __forceinline__ DualT<N> tabs(const DualT<N>& x) {
  return x.v < 0.0f ? -x : x;
}

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
__device__ __forceinline__ Quat<T> quat_from_rotvec(const T& rx, const T& ry,
                                                   const T& rz) {
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

// quat_slerp(q0, q1, t) split in two: what does not depend on t (the sign
// flip, the clip, the branch, the angle) once a pose, then the blend a row.
template <class T>
struct Slerp {
  Quat<T> q0, q1;          // q1 flipped to q0's hemisphere
  T theta, sin_theta;      // unused on the nlerp branch
  bool near;               // the nlerp fallback
};

template <class T>
__device__ __forceinline__ Slerp<T> slerp_setup(const Quat<T>& q0,
                                               Quat<T> q1) {
  T d = q0.w * q1.w + q0.x * q1.x + q0.y * q1.y + q0.z * q1.z;
  if (val(d) < 0.0f) q1 = {-q1.w, -q1.x, -q1.y, -q1.z};
  d = tclip(tabs(d), -1.0f, 1.0f);
  Slerp<T> s{q0, q1, T{0.0f}, T{0.0f},
             val(d) > static_cast<float>(1.0 - 1e-7)};
  if (!s.near) {
    s.theta = tacos(d);
    s.sin_theta = tsin(s.theta);
  }
  return s;
}

template <class T>
__device__ __forceinline__ Quat<T> slerp_at(const Slerp<T>& s, float t) {
  const Quat<T>& q0 = s.q0;
  const Quat<T>& q1 = s.q1;
  if (s.near) {
    const float w0 = 1.0f - t, w1 = t;
    return quat_normalize(Quat<T>{w0 * q0.w + w1 * q1.w, w0 * q0.x + w1 * q1.x,
                                  w0 * q0.y + w1 * q1.y,
                                  w0 * q0.z + w1 * q1.z});
  }
  const T w0 = tsin((1.0f - t) * s.theta) / s.sin_theta;
  const T w1 = tsin(t * s.theta) / s.sin_theta;
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

// the point-to-plane residual of one row at pose p (s = its slerp setup)
template <class T>
__device__ __forceinline__ T plane_residual(const Pose<T>& p,
                                           const Slerp<T>& s,
                                           const float* row) {
  const float a = row[3];
  const Quat<T> qi = slerp_at(s, a);
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The tangent of column j (the Dual1 results of one thread a column) into
// tangent j % 6 of the half j / 6 of the pose's Dual6 tangents; the values
// from the first column of each half. A Dual6 carries each tangent bit for
// bit as a Dual1 would, so the columns can be computed apart.
template <class Small, class Big>
__device__ __forceinline__ void scatter_tangent(const Small& one, Big& six,
                                                int t, int n_duals) {
  const float* src = reinterpret_cast<const float*>(&one);
  float* dst = reinterpret_cast<float*>(&six);
  for (int e = 0; e < n_duals; ++e) {
    dst[e * (kTan + 1) + 1 + t] = src[2 * e + 1];
    if (t == 0) dst[e * (kTan + 1)] = src[2 * e];
  }
}
static_assert(sizeof(Pose<Dual6>) == 14 * (kTan + 1) * 4 &&
                  sizeof(Pose<Dual1>) == 14 * 2 * 4,
              "a pose is 14 packed duals");
static_assert(offsetof(Slerp<Dual6>, near) == 10 * sizeof(Dual6) &&
                  offsetof(Slerp<Dual1>, near) == 10 * sizeof(Dual1),
              "a slerp setup is 10 packed duals, then its branch");

// The 12x12 solve of one warp, lane a holding row a (lanes >= 12 hold
// zeros and their results are dropped): the partial pivoting of a serial
// Gaussian elimination (the first row of the largest |pivot|, a NaN never
// taken), then back substitution in the serial order. Returns x in every
// lane.
__device__ __forceinline__ void solve12_warp(float m[12], float x,
                                             float xs[12]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int col = 0; col < 12; ++col) {
    // the candidates below the diagonal: |m| as its bits plus one (the
    // order of non-negative floats; 0 for no candidate and for a NaN,
    // which the serial scan never takes); the largest, first lane on ties
    const float mag = fabsf(m[col]);
    const unsigned key = (lane > col && lane < 12 && mag == mag)
                             ? __float_as_uint(mag) + 1u : 0u;
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    int piv = __ffs(__ballot_sync(0xffffffffu, key == top)) - 1;
    // the serial scan starts from the diagonal and takes a row only when
    // it is strictly larger
    const float diag = fabsf(__shfl_sync(0xffffffffu, m[col], col));
    if (top == 0u || !(__uint_as_float(top - 1u) > diag)) piv = col;
    if (piv != col) {
      const int from = lane == col ? piv : (lane == piv ? col : lane);
#pragma unroll
      for (int c = 0; c < 12; ++c) m[c] = __shfl_sync(0xffffffffu, m[c], from);
      x = __shfl_sync(0xffffffffu, x, from);
    }
    const float pcol = __shfl_sync(0xffffffffu, m[col], col);
    const float xcol = __shfl_sync(0xffffffffu, x, col);
    const float f = m[col] / pcol;
#pragma unroll
    for (int c = col; c < 12; ++c) {
      const float pc = __shfl_sync(0xffffffffu, m[c], col);
      if (lane > col) m[c] = m[c] - f * pc;
    }
    if (lane > col) x = x - f * xcol;
  }
#pragma unroll
  for (int r = 11; r >= 0; --r) {
    float s = x;
#pragma unroll
    for (int c = r + 1; c < 12; ++c) s = s - m[c] * xs[c];
    xs[r] = __shfl_sync(0xffffffffu, s / m[r], r);
  }
}

}  // namespace cticp
