// K14 scan_transform: the scan's wire unpack and the per-point
// continuous-time transform.
//
// Replaces three functions of ct_icp_tpu/odometry/pipeline.py, XLA
// elementwise programs on the TPU:
//   * unpack_scan (:125): u16 [R, 4] wire rows -> xyz f32 [R, 3] (int16 at
//     1/128 m) and alphas f32 [R] (code / 65535);
//   * transform_points (:66): world = slerp(qb, qe, a) * raw + lerp(tb, te,
//     a) for each point (core/math_impl.py's quat_slerp, quat_rotate and
//     se3_interpolate);
//   * distort_raw (:56): the same, then end^-1 * world (the
//     CONSTANT_VELOCITY motion compensation).
// A thread a row. The slerp's setup (the 4-term dot, the sign flip, the
// clip, the nlerp branch, acos and sin; for distort_raw also the end pose's
// inverse) does not depend on the point: the block's first thread computes
// it once into shared memory from the poses on the device (no host read),
// then every thread blends its own alpha (csrc/dual.cuh's slerp_setup /
// slerp_at split, in primal mode).
//
// The arithmetic is the plain PyTorch version's, operation by operation:
// round-to-nearest intrinsics where torch rounds between its elementwise
// kernels (the file is also built with -fmad=false), IEEE division and
// sqrt, libdevice's sinf and acosf (what torch's CUDA sin and acos call).
// torch's CUDA reduction sums the quaternions' four products (the slerp
// dot and the normalizations, of an [N, 4] tensor and of a [4] one) as
// (a0 + a2) + (a1 + a3), and so does sum4: with that order the outputs are
// the plain version's bit for bit (chip_smoke.py and the card tests hold
// them so); left to right, or (a0 + a1) + (a2 + a3), they are not.
//
// Bound: bytes. unpack reads 8 B a row and writes 16 B; transform reads
// 16 B a point (xyz and alpha) and writes 12 B; ~60 flops and two sinf a
// point, far below the card's rate. At the scan's 32,768-131,072 rows the
// launch's floor is of the order of the bytes' time.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kScanQuant = 128.0f;          // 1/128 m per LSB
constexpr float kAlphaScale = 65535.0f;
// 1.0 - 1e-7 as torch compares a float32 tensor with it (the Python double
// rounded to float32)
constexpr float kNear = static_cast<float>(1.0 - 1e-7);

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// torch.sum over a last dimension of 4, in its order
__device__ __forceinline__ float sum4(float a0, float a1, float a2,
                                      float a3) {
  return add(add(a0, a2), add(a1, a3));
}

struct Quat {
  float w, x, y, z;
};
struct Vec3 {
  float x, y, z;
};

// core/math_impl.py::quat_normalize: q / max(sqrt(sum(q * q)), 1e-30)
__device__ __forceinline__ Quat normalize(const Quat& q) {
  float n = __fsqrt_rn(sum4(mul(q.w, q.w), mul(q.x, q.x), mul(q.y, q.y),
                            mul(q.z, q.z)));
  n = n < 1e-30f ? 1e-30f : n;
  return {__fdiv_rn(q.w, n), __fdiv_rn(q.x, n), __fdiv_rn(q.y, n),
          __fdiv_rn(q.z, n)};
}

// core/se3.py::_cross
__device__ __forceinline__ Vec3 cross(const Vec3& a, const Vec3& b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}

// quat_rotate(q, v) = v + w t + qv x t, t = 2 (qv x v)
__device__ __forceinline__ Vec3 rotate(const Quat& q, const Vec3& v) {
  const Vec3 qv{q.x, q.y, q.z};
  const Vec3 c = cross(qv, v);
  const Vec3 t{mul(2.0f, c.x), mul(2.0f, c.y), mul(2.0f, c.z)};
  const Vec3 c2 = cross(qv, t);
  return {add(add(v.x, mul(q.w, t.x)), c2.x),
          add(add(v.y, mul(q.w, t.y)), c2.y),
          add(add(v.z, mul(q.w, t.z)), c2.z)};
}

// What a launch computes once: the slerp's endpoints (qe flipped to qb's
// hemisphere), its branch and angle, the translations, and for distort_raw
// the end pose's inverse.
struct Setup {
  Quat q0, q1;
  float theta, sin_theta;   // sin_theta is 1 on the nlerp branch
  int near;
  Vec3 tb, te;
  Quat qi;                  // conj(normalize(qe))
  Vec3 ti;                  // -(qi * te)
};

__device__ Setup make_setup(const float* qb, const float* tb, const float* qe,
                            const float* te, bool distort) {
  Setup s;
  s.q0 = {qb[0], qb[1], qb[2], qb[3]};
  Quat q1{qe[0], qe[1], qe[2], qe[3]};
  float d = sum4(mul(s.q0.w, q1.w), mul(s.q0.x, q1.x), mul(s.q0.y, q1.y),
                 mul(s.q0.z, q1.z));
  if (d < 0.0f) q1 = {-q1.w, -q1.x, -q1.y, -q1.z};
  d = fabsf(d);
  d = fminf(fmaxf(d, -1.0f), 1.0f);
  s.q1 = q1;
  s.near = d > kNear;
  s.theta = acosf(s.near ? 0.0f : d);
  const float st = sinf(s.theta);
  s.sin_theta = s.near ? 1.0f : st;
  s.tb = {tb[0], tb[1], tb[2]};
  s.te = {te[0], te[1], te[2]};
  if (distort) {
    const Quat n = normalize({qe[0], qe[1], qe[2], qe[3]});
    s.qi = {n.w, -n.x, -n.y, -n.z};
    const Vec3 r = rotate(s.qi, s.te);
    s.ti = {-r.x, -r.y, -r.z};
  }
  return s;
}

// se3_interpolate at alpha a, then the point moved: rot + lerp
__device__ __forceinline__ Vec3 transform_one(const Setup& s, float a,
                                              const Vec3& raw) {
  const float b = sub(1.0f, a);
  float w0, w1;
  if (s.near) {
    w0 = b;
    w1 = a;
  } else {
    w0 = __fdiv_rn(sinf(mul(b, s.theta)), s.sin_theta);
    w1 = __fdiv_rn(sinf(mul(a, s.theta)), s.sin_theta);
  }
  const Quat q = normalize({add(mul(w0, s.q0.w), mul(w1, s.q1.w)),
                            add(mul(w0, s.q0.x), mul(w1, s.q1.x)),
                            add(mul(w0, s.q0.y), mul(w1, s.q1.y)),
                            add(mul(w0, s.q0.z), mul(w1, s.q1.z))});
  const Vec3 rot = rotate(q, raw);
  return {add(rot.x, add(mul(b, s.tb.x), mul(a, s.te.x))),
          add(rot.y, add(mul(b, s.tb.y), mul(a, s.te.y))),
          add(rot.z, add(mul(b, s.tb.z), mul(a, s.te.z)))};
}

__global__ void __launch_bounds__(kThreads)
    unpack_kernel(const uint16_t* __restrict__ packed, int rows,
                  float* __restrict__ xyz, float* __restrict__ alphas) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows) return;
  const uint16_t* r = packed + 4 * static_cast<size_t>(i);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    xyz[3 * static_cast<size_t>(i) + c] =
        __fdiv_rn(static_cast<float>(static_cast<int16_t>(r[c])), kScanQuant);
  alphas[i] = __fdiv_rn(static_cast<float>(r[3]), kAlphaScale);
}

__global__ void __launch_bounds__(kThreads)
    transform_kernel(const float* __restrict__ raw,
                     const float* __restrict__ alphas, int n,
                     const float* __restrict__ qb, const float* __restrict__ tb,
                     const float* __restrict__ qe, const float* __restrict__ te,
                     int distort, float* __restrict__ out) {
  __shared__ Setup shared;
  if (threadIdx.x == 0) shared = make_setup(qb, tb, qe, te, distort != 0);
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Setup& s = shared;
  const size_t at = 3 * static_cast<size_t>(i);
  Vec3 w = transform_one(s, alphas[i], {raw[at], raw[at + 1], raw[at + 2]});
  if (distort) {
    const Vec3 r = rotate(s.qi, w);
    w = {add(r.x, s.ti.x), add(r.y, s.ti.y), add(r.z, s.ti.z)};
  }
  out[at] = w.x;
  out[at + 1] = w.y;
  out[at + 2] = w.z;
}

}  // namespace

// the block's threads
extern "C" int k14_threads() { return kThreads; }

// packed: u16 [rows, 4] (the int16 view of pack_scan_u16's rows) on
// `blocks` blocks of kThreads rows (kernels/scan_transform.py::grid_blocks);
// xyz f32 [rows, 3], alphas f32 [rows] out.
extern "C" int k14_unpack(const void* packed, int rows, int blocks,
                          void* xyz, void* alphas, void* stream) {
  if (rows < 0 || static_cast<long long>(blocks) * kThreads < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0)
    unpack_kernel<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(packed), rows,
        static_cast<float*>(xyz), static_cast<float*>(alphas));
  return static_cast<int>(cudaGetLastError());
}

// raw f32 [n, 3], alphas f32 [n] on `blocks` blocks of kThreads points;
// qb, qe f32 [4] and tb, te f32 [3] on the device; distort != 0:
// distort_raw, else transform_points; out f32 [n, 3].
extern "C" int k14_transform(const void* raw, const void* alphas, int n,
                             int blocks, const void* qb, const void* tb,
                             const void* qe, const void* te, int distort,
                             void* out, void* stream) {
  if (n < 0 || static_cast<long long>(blocks) * kThreads < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    transform_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(raw), static_cast<const float*>(alphas), n,
        static_cast<const float*>(qb), static_cast<const float*>(tb),
        static_cast<const float*>(qe), static_cast<const float*>(te),
        distort, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
