// The closed-form 3x3 eigensolve of ops/eigen3.py (ct_icp_tpu/ops/eigen3.py
// ::eigh3x3, :18-82) as device code: the trigonometric eigenvalues, the
// smallest eigenvalue's vector by the largest row cross product,
// orthogonalized against the largest's. Shared by K2 plane_moments (its
// descriptor epilogue) and K10 level_normals (the per-voxel plane fit).
// The functions have internal linkage, so a kernel that includes the header
// compiles them as its own (K2's code is unchanged by the move).
#pragma once
#include <cmath>

#include <cuda_runtime.h>

namespace cticp {

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
static __device__ void eigvec(const float a[3][3], float lam, float* out) {
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

// eigh3x3's smallest-eigenvalue vector and the eigenvalues (descending);
// with a non-null `line`, also the largest eigenvalue's vector (eigvecs[0]).
static __device__ Eig eigh3x3_normal(const float a[3][3],
                                     float* line = nullptr) {
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
    if (line != nullptr) {
      line[0] = 1.0f;
      line[1] = 0.0f;
      line[2] = 0.0f;
    }
    return e;
  }
  float v0[3], v2[3];
  eigvec(a, l0, v0);
  if (line != nullptr) {
    line[0] = v0[0];
    line[1] = v0[1];
    line[2] = v0[2];
  }
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

}  // namespace cticp
