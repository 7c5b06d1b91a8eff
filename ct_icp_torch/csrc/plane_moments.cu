// K2 plane_moments: in-radius moment rescore + descriptor of cached
// candidate rows.
//
// Replaces ct_icp_tpu/mapping/voxel_map.py::moments_from_planes and
// ::_knn_radius2 (:722-818), ops/neighborhood.py::description_from_moments
// (:94-120) and ops/eigen3.py::eigh3x3 (:18-82).
//
// One warp per keypoint walks its O x P candidates (flattened [O, P], lanes
// on consecutive points of a plane, so each load is coalesced):
//   1. d2 to the query and the in-radius mask (point index < voxel count);
//   2. on regather calls only: the 32 nested-shell counts of _knn_radius2 as
//      a per-warp shared-memory histogram of each candidate's first shell,
//      a warp prefix scan, and the first shell whose count reaches k — the
//      capped radius r_eff2 (otherwise the caller's cached r_eff2);
//   3. count, sum_rel and sum_outer under d2 <= r_eff2, and the closest
//      candidate (ties go to the first flat index, as argmin does);
//   4. epilogue in registers on lane 0: covariance, closed-form 3x3
//      eigensolve, normal and a2D.
// The TPU version materialised a [M, O, P, 32] compare tensor for step 2;
// here the histogram never leaves shared memory.
//
// Bound: bytes — the candidate rows (M x O x 3P floats) are read once per
// pass; the arithmetic per byte is a few operations. Float sums are taken in
// a warp-tree order, so they differ from the plain version in the last bits;
// counts, shells and the closest index come from compares of d2 values that
// are computed identically (no FMA contraction: built with -fmad=false).
#include "common.cuh"

namespace {

constexpr int kBins = 32;
constexpr int kWarpsPerBlock = 4;

struct Eig {
  float normal[3];
  float vals[3];
};

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void normalize3(float* v) {
  const float n = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  const float d = n > 1e-20f ? n : 1.0f;
  v[0] /= d;
  v[1] /= d;
  v[2] /= d;
}

// Unit null vector of (a - lam I) via the largest row cross product.
__device__ void eigvec(const float a[3][3], float lam, float* out) {
  float r[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r[i][j] = a[i][j] - (i == j ? lam : 0.0f);
  float c[3][3];
  cross3(r[0], r[1], c[0]);
  cross3(r[0], r[2], c[1]);
  cross3(r[1], r[2], c[2]);
  int best = 0;
  float best_n = c[0][0] * c[0][0] + c[0][1] * c[0][1] + c[0][2] * c[0][2];
  for (int k = 1; k < 3; ++k) {
    const float nk = c[k][0] * c[k][0] + c[k][1] * c[k][1] + c[k][2] * c[k][2];
    if (nk > best_n) {
      best_n = nk;
      best = k;
    }
  }
  if (best_n > 1e-30f) {
    out[0] = c[best][0];
    out[1] = c[best][1];
    out[2] = c[best][2];
  } else {
    out[0] = 1.0f;
    out[1] = 0.0f;
    out[2] = 0.0f;
  }
  normalize3(out);
}

// eigh3x3's smallest-eigenvalue vector and the eigenvalues (descending).
__device__ Eig eigh3x3_normal(const float a[3][3]) {
  Eig e;
  const float q = (a[0][0] + a[1][1] + a[2][2]) / 3.0f;
  float b[3][3];
  float p2 = 0.0f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      b[i][j] = a[i][j] - (i == j ? q : 0.0f);
      p2 += b[i][j] * b[i][j];
    }
  p2 /= 6.0f;
  const float p = sqrtf(fmaxf(p2, 0.0f));
  const float p_safe = p > 1e-20f ? p : 1.0f;
  const float detb =
      b[0][0] * (b[1][1] * b[2][2] - b[1][2] * b[2][1]) -
      b[0][1] * (b[1][0] * b[2][2] - b[1][2] * b[2][0]) +
      b[0][2] * (b[1][0] * b[2][1] - b[1][1] * b[2][0]);
  const float r =
      fminf(fmaxf(detb / (2.0f * (p_safe * p_safe * p_safe)), -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  const float l0 = q + 2.0f * p * cosf(phi);
  const float l2 = q + 2.0f * p * cosf(phi + 2.0943951023931953f);
  const float l1 = 3.0f * q - l0 - l2;
  if (p <= 1e-12f * fmaxf(fabsf(q), 1.0f)) {  // isotropic: identity basis
    e.normal[0] = 0.0f;
    e.normal[1] = 0.0f;
    e.normal[2] = 1.0f;
    e.vals[0] = e.vals[1] = e.vals[2] = q;
    return e;
  }
  float v0[3], v2[3];
  eigvec(a, l0, v0);
  eigvec(a, l2, v2);
  const float d = v2[0] * v0[0] + v2[1] * v0[1] + v2[2] * v0[2];
  for (int i = 0; i < 3; ++i) v2[i] -= d * v0[i];
  normalize3(v2);
  e.normal[0] = v2[0];
  e.normal[1] = v2[1];
  e.normal[2] = v2[2];
  e.vals[0] = l0;
  e.vals[1] = l1;
  e.vals[2] = l2;
  return e;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__global__ void plane_moments_kernel(
    const float* __restrict__ rows, const int32_t* __restrict__ cnt_ok,
    const float* __restrict__ queries, int m, int n_off, int p, float rr,
    int k_nearest, const float* __restrict__ cached_r_eff2,
    int32_t* __restrict__ out_count, float* __restrict__ out_sum_rel,
    float* __restrict__ out_sum_outer, float* __restrict__ out_closest,
    float* __restrict__ out_closest_dist, float* __restrict__ out_r_eff2,
    float* __restrict__ out_normal, float* __restrict__ out_a2d) {
  __shared__ int hist[kWarpsPerBlock][kBins];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarpsPerBlock + wib;
  if (qi >= m) return;  // whole warp

  const float qx = queries[3 * qi + 0];
  const float qy = queries[3 * qi + 1];
  const float qz = queries[3 * qi + 2];
  const int row_len = 3 * p;
  const int total = n_off * p;
  const float* base = rows + static_cast<size_t>(qi) * n_off * row_len;
  const int32_t* cnt = cnt_ok + static_cast<size_t>(qi) * n_off;
  const float r2 = fmaxf(rr, 1e-20f);  // _knn_radius2's r2

  // ---- r_eff2: fresh shell histogram, cached value, or the full radius
  float r_eff2 = rr;
  if (k_nearest >= 0) {
    if (cached_r_eff2 != nullptr) {
      r_eff2 = cached_r_eff2[qi];
    } else {
      hist[wib][lane] = 0;
      __syncwarp();
      for (int i = lane; i < total; i += 32) {
        const int o = i / p;
        const int j = i - o * p;
        if (j >= cnt[o]) continue;
        const float* row = base + static_cast<size_t>(o) * row_len;
        const float dx = row[j] - qx, dy = row[p + j] - qy,
                    dz = row[2 * p + j] - qz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (!(d2 <= rr)) continue;
        // first shell b with d2 <= r2 * ((b+1)/32)^2 (edges non-decreasing)
        int lo = 0, hi = kBins - 1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const float f = static_cast<float>(mid + 1) / kBins;
          if (d2 <= r2 * (f * f)) hi = mid; else lo = mid + 1;
        }
        atomicAdd(&hist[wib][lo], 1);
      }
      __syncwarp();
      int c = hist[wib][lane];
      for (int s = 1; s < 32; s <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, c, s);
        if (lane >= s) c += up;
      }
      const int kk = k_nearest > 1 ? k_nearest : 1;
      const unsigned reach = __ballot_sync(0xffffffffu, c >= kk);
      if (reach != 0u && k_nearest > 0) {
        const float f = static_cast<float>(__ffs(reach)) / kBins;
        r_eff2 = r2 * (f * f);
      } else {
        r_eff2 = r2;
      }
    }
  }

  // ---- moments + closest under d2 <= r_eff2
  int n = 0;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  float sxx = 0.f, sxy = 0.f, sxz = 0.f, syy = 0.f, syz = 0.f, szz = 0.f;
  float best_d2 = __int_as_float(0x7f800000);  // +inf
  int best_i = 0x7fffffff;
  for (int i = lane; i < total; i += 32) {
    const int o = i / p;
    const int j = i - o * p;
    if (j >= cnt[o]) continue;
    const float* row = base + static_cast<size_t>(o) * row_len;
    const float dx = row[j] - qx, dy = row[p + j] - qy,
                dz = row[2 * p + j] - qz;
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (!(d2 <= rr) || !(d2 <= r_eff2)) continue;
    ++n;
    sx += dx;
    sy += dy;
    sz += dz;
    sxx += dx * dx;
    sxy += dx * dy;
    sxz += dx * dz;
    syy += dy * dy;
    syz += dy * dz;
    szz += dz * dz;
    if (d2 < best_d2) {  // lanes visit their indices in increasing order
      best_d2 = d2;
      best_i = i;
    }
  }
  for (int s = 16; s > 0; s >>= 1) {
    n += __shfl_xor_sync(0xffffffffu, n, s);
    const float od = __shfl_xor_sync(0xffffffffu, best_d2, s);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, s);
    if (od < best_d2 || (od == best_d2 && oi < best_i)) {
      best_d2 = od;
      best_i = oi;
    }
  }
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  sz = warp_sum(sz);
  sxx = warp_sum(sxx);
  sxy = warp_sum(sxy);
  sxz = warp_sum(sxz);
  syy = warp_sum(syy);
  syz = warp_sum(syz);
  szz = warp_sum(szz);
  if (lane != 0) return;

  // closest point; with no candidate, argmin over all-inf picks index 0
  const int ci = n > 0 ? best_i : 0;
  const int co = ci / p, cj = ci - co * p;
  const float* crow = base + static_cast<size_t>(co) * row_len;
  out_closest[3 * qi + 0] = crow[cj];
  out_closest[3 * qi + 1] = crow[p + cj];
  out_closest[3 * qi + 2] = crow[2 * p + cj];
  out_closest_dist[qi] = n > 0 ? sqrtf(best_d2) : __int_as_float(0x7f800000);
  out_count[qi] = n;
  out_r_eff2[qi] = r_eff2;
  const float so[3][3] = {{sxx, sxy, sxz}, {sxy, syy, syz}, {sxz, syz, szz}};
  const float sr[3] = {sx, sy, sz};
  out_sum_rel[3 * qi + 0] = sx;
  out_sum_rel[3 * qi + 1] = sy;
  out_sum_rel[3 * qi + 2] = sz;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) out_sum_outer[9 * qi + 3 * a + b] = so[a][b];

  // ---- descriptor epilogue (description_from_moments)
  const float cs = fmaxf(static_cast<float>(n), 1.0f);
  float mean[3], cov[3][3];
  for (int a = 0; a < 3; ++a) mean[a] = sr[a] / cs;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) cov[a][b] = so[a][b] / cs - mean[a] * mean[b];
  const Eig e = eigh3x3_normal(cov);
  const float s0 = fmaxf(fabsf(e.vals[0]), 1e-20f);
  const float s1 = fabsf(e.vals[1]), s2 = fabsf(e.vals[2]);
  out_normal[3 * qi + 0] = e.normal[0];
  out_normal[3 * qi + 1] = e.normal[1];
  out_normal[3 * qi + 2] = e.normal[2];
  out_a2d[qi] = (sqrtf(s1) - sqrtf(s2)) / sqrtf(s0);
}

}  // namespace

// k_nearest < 0: no shell cap (r_eff2 = radius^2). cached_r_eff2 == NULL:
// compute the shell radius fresh.
extern "C" int k2_plane_moments(const void* rows, const void* cnt_ok,
                                const void* queries, int m, int n_off, int p,
                                float rr, int k_nearest,
                                const void* cached_r_eff2, void* count,
                                void* sum_rel, void* sum_outer, void* closest,
                                void* closest_dist, void* r_eff2, void* normal,
                                void* a2d, void* stream) {
  if (m > 0) {
    const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
    plane_moments_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), static_cast<const int32_t*>(cnt_ok),
        static_cast<const float*>(queries), m, n_off, p, rr, k_nearest,
        static_cast<const float*>(cached_r_eff2),
        static_cast<int32_t*>(count), static_cast<float*>(sum_rel),
        static_cast<float*>(sum_outer), static_cast<float*>(closest),
        static_cast<float*>(closest_dist), static_cast<float*>(r_eff2),
        static_cast<float*>(normal), static_cast<float*>(a2d));
  }
  return static_cast<int>(cudaGetLastError());
}
