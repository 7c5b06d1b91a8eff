// K2 plane_moments: in-radius moment rescore + descriptor, reading the live
// map points through K1's slots.
//
// Replaces ct_icp_tpu/mapping/voxel_map.py::moments_from_planes and
// ::_knn_radius2 (:722-818), ops/neighborhood.py::description_from_moments
// (:94-120) and ops/eigen3.py::eigh3x3 (:18-82). The reference rescored a
// cached [M, O', 3P] copy of the candidate rows (TPU layout); here point j of
// candidate o of query q is read from the map, at points[slots[q, o]][j],
// [P + j] and [2P + j], for j < cnt_ok[q, o] (the live points) only.
//
// A group of G = K2_GROUP lanes (a warp, 32, in the main build; 8 and 16 are
// measurement variants, tools/exp_moments.py) owns one query:
//   1. it loads the query's O' (slot, cnt_ok) pairs into shared memory and
//      exclusive-scans the counts into live offsets;
//   2. lane l walks live indices l, l + G, l + 2G, ... (a cursor steps over
//      the offsets to (o, j)), so the group's lanes read consecutive j of
//      one voxel plane, kUnroll points a lane in flight;
//   3. on a fresh call only: the 32 nested-shell counts of _knn_radius2 as a
//      shared-memory histogram of each in-radius point's first shell (a
//      binary search over the 32 shell edges, computed once a query), a
//      group scan, and the first shell whose count reaches k: the capped
//      radius r_eff2 (else the caller's cached r_eff2, or the full radius);
//      the lane's first kCachedBatches * kUnroll points stay in registers
//      for step 4;
//   4. count, sum_rel and sum_outer under d2 <= r_eff2, and the closest
//      point (ties to the least flat index o * P + j, in K1's order);
//   5. the group's sums by shuffles, into shared memory; after a block
//      barrier, lane e of the block's first warp runs query e's epilogue:
//      closest (with no in-radius point: point 0 of candidate 0, as the
//      reference's argmin over all-inf), covariance, closed-form 3x3
//      eigensolve, normal and a2D, kThreads / G of them at once.
//
// The radius is one scalar (rr, squared on the host) or, with a non-NULL
// ``radius``, one a query (the distance strategy's, voxel_map.py:722-749's
// radius_arr), squared here in round to nearest: the in-radius test and
// the 32 nested shell edges are then the query's own. A scalar radius runs
// the same code as before, with the same outputs.
//
// Bound: bytes. Each distinct live map point read once (12 B), the
// (slot, cnt_ok) pairs, the queries and the outputs; a few operations per
// byte. Float sums are taken in another order than the plain version's, so
// they differ in the last bits; counts, shells and the closest index come
// from compares of d2 values computed identically (dx*dx + dy*dy + dz*dz,
// no FMA contraction: built with -fmad=false).
#include "common.cuh"
#include "eigh3.cuh"

#ifndef K2_GROUP
#define K2_GROUP 32
#endif

namespace {

using cticp::Eig;
using cticp::eigh3x3_normal;

constexpr int kGroup = K2_GROUP;
static_assert(kGroup == 8 || kGroup == 16 || kGroup == 32,
              "K2_GROUP is 8, 16 or 32");
constexpr int kBins = 32;
constexpr int kThreads = 128;
constexpr int kGroupsPerBlock = kThreads / kGroup;
constexpr int kUnroll = 4;          // live points a lane loads at once
constexpr int kCachedBatches = 2;   // batches kept for a fresh call's sums

__device__ __forceinline__ unsigned group_mask() {
  const int lane = threadIdx.x & 31;
  return kGroup == 32 ? 0xffffffffu
                      : ((1u << kGroup) - 1u) << (lane & ~(kGroup - 1));
}

template <typename T>
__device__ __forceinline__ T group_sum(unsigned mask, T v) {
  for (int s = kGroup / 2; s > 0; s >>= 1) v += __shfl_xor_sync(mask, v, s);
  return v;
}

__device__ __forceinline__ int group_inclusive_scan(unsigned mask, int gl,
                                                    int v) {
  for (int s = 1; s < kGroup; s <<= 1) {
    const int up = __shfl_up_sync(mask, v, s, kGroup);
    if (gl >= s) v += up;
  }
  return v;
}

// A lane's place in its query's live points: live index i lies in
// candidate o (off[o] <= i < off[o + 1]) while i < the live total.
struct Cursor {
  int i;
  int o;
};

// One batch of kUnroll live points of the lane: offsets to the query
// (dx, dy, dz) and the flat index o * P + j, -1 past the live total.
struct Batch {
  float dx[kUnroll], dy[kUnroll], dz[kUnroll];
  int flat[kUnroll];
};

struct Query {
  const float* points;
  const int* off;    // [O' + 1] exclusive scan of cnt_ok (shared memory)
  const int* slot;   // [O'] (shared memory)
  int total;         // live points
  int p;
  float qx, qy, qz;
};

__device__ __forceinline__ void load_batch(const Query& q, Cursor& c,
                                           Batch& b) {
  float x[kUnroll], y[kUnroll], z[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    b.flat[u] = -1;
    x[u] = y[u] = z[u] = 0.0f;
    if (c.i < q.total) {
      while (q.off[c.o + 1] <= c.i) ++c.o;
      const int j = c.i - q.off[c.o];
      const float* row =
          q.points + static_cast<size_t>(q.slot[c.o]) * (3 * q.p);
      x[u] = row[j];
      y[u] = row[q.p + j];
      z[u] = row[2 * q.p + j];
      b.flat[u] = c.o * q.p + j;
    }
    c.i += kGroup;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    b.dx[u] = x[u] - q.qx;
    b.dy[u] = y[u] - q.qy;
    b.dz[u] = z[u] - q.qz;
  }
}

template <typename F>
__device__ __forceinline__ void for_batch(const Batch& b, F&& f) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (b.flat[u] >= 0) f(b.dx[u], b.dy[u], b.dz[u], b.flat[u]);
}

// every live point of the lane from cursor c on
template <typename F>
__device__ __forceinline__ void walk(const Query& q, Cursor c, F&& f) {
  while (c.i < q.total) {
    Batch b;
    load_batch(q, c, b);
    for_batch(b, f);
  }
}

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return dx * dx + dy * dy + dz * dz;
}

// the per-query results a group hands to the block's epilogue lanes
enum Result { kN, kSx, kSy, kSz, kSxx, kSxy, kSxz, kSyy, kSyz, kSzz,
              kBestD2, kBestI, kReff2, kResults };

__global__ void __launch_bounds__(kThreads) plane_moments_kernel(
    const float* __restrict__ points, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ cnt_ok, const float* __restrict__ queries,
    int m, int n_off, int p, float rr_all, const float* __restrict__ radius,
    int k_nearest, const float* __restrict__ cached_r_eff2,
    int32_t* __restrict__ out_count,
    float* __restrict__ out_sum_rel, float* __restrict__ out_sum_outer,
    float* __restrict__ out_closest, float* __restrict__ out_closest_dist,
    float* __restrict__ out_r_eff2, float* __restrict__ out_normal,
    float* __restrict__ out_a2d) {
  extern __shared__ int smem[];
  const int gl = threadIdx.x & (kGroup - 1);
  const int gib = threadIdx.x / kGroup;
  const int stride = 2 * n_off + 1 + 2 * kBins + kResults;
  int* off = smem + gib * stride;                          // [O' + 1]
  int* slot = off + n_off + 1;                             // [O']
  int* hist = slot + n_off;                                // [kBins]
  float* edge = reinterpret_cast<float*>(hist + kBins);    // [kBins]
  int* res = reinterpret_cast<int*>(edge + kBins);         // [kResults]
  const int qi = blockIdx.x * kGroupsPerBlock + gib;
  const float rr = radius != nullptr && qi < m
                       ? __fmul_rn(radius[qi], radius[qi])
                       : rr_all;
  const float r2 = fmaxf(rr, 1e-20f);  // _knn_radius2's r2

  if (qi < m) {  // the whole group, which then meets the block's barrier
    const unsigned gm = group_mask();
    // ---- 1. the pairs, and the live offsets
    const int32_t* q_slots = slots + static_cast<size_t>(qi) * n_off;
    const int32_t* q_cnt = cnt_ok + static_cast<size_t>(qi) * n_off;
#pragma unroll 4
    for (int o = gl; o < n_off; o += kGroup) {
      slot[o] = q_slots[o];
      off[o] = q_cnt[o];
    }
    __syncwarp(gm);
    int total = 0;
    for (int base = 0; base < n_off; base += kGroup) {
      const int o = base + gl;
      const int c = o < n_off ? off[o] : 0;
      const int incl = group_inclusive_scan(gm, gl, c);
      if (o < n_off) off[o] = total + incl - c;
      total += __shfl_sync(gm, incl, kGroup - 1, kGroup);
    }
    if (gl == 0) off[n_off] = total;
    __syncwarp(gm);

    const Query q{points, off, slot, total, p, queries[3 * qi + 0],
                  queries[3 * qi + 1], queries[3 * qi + 2]};

    // ---- 2. the lane's first points, kept for the sums
    Cursor cur{gl, 0};
    Batch kept[kCachedBatches];
#pragma unroll
    for (int b = 0; b < kCachedBatches; ++b) load_batch(q, cur, kept[b]);
    const Cursor rest = cur;

    // ---- 3. r_eff2: fresh shell histogram, cached value, or full radius
    float r_eff2 = rr;
    if (k_nearest >= 0) {
      if (cached_r_eff2 != nullptr) {
        r_eff2 = cached_r_eff2[qi];
      } else {
        for (int b = gl; b < kBins; b += kGroup) {
          const float f = static_cast<float>(b + 1) / kBins;
          edge[b] = r2 * (f * f);
          hist[b] = 0;
        }
        __syncwarp(gm);
        // first shell b with d2 <= edge[b] (edges non-decreasing)
        auto shell = [&](float dx, float dy, float dz, int) {
          const float d2 = dist2(dx, dy, dz);
          if (!(d2 <= rr)) return;
          int lo = 0;
#pragma unroll
          for (int step = kBins / 2; step > 0; step >>= 1)
            if (!(d2 <= edge[lo + step - 1])) lo += step;
          atomicAdd(hist + lo, 1);
        };
#pragma unroll
        for (int b = 0; b < kCachedBatches; ++b) for_batch(kept[b], shell);
        walk(q, rest, shell);
        __syncwarp(gm);
        constexpr int kPer = kBins / kGroup;
        int cum[kPer];
        int run = 0;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          run += hist[gl * kPer + k];
          cum[k] = run;
        }
        const int before = group_inclusive_scan(gm, gl, run) - run;
        const int kk = k_nearest > 1 ? k_nearest : 1;
        int first = kBins;
#pragma unroll
        for (int k = kPer - 1; k >= 0; --k)
          if (before + cum[k] >= kk) first = gl * kPer + k;
        for (int s = kGroup / 2; s > 0; s >>= 1)
          first = min(first, __shfl_xor_sync(gm, first, s));
        r_eff2 = first < kBins && k_nearest > 0 ? edge[first] : r2;
      }
    }

    // ---- 4. moments + closest under d2 <= r_eff2
    int n = 0;
    float sx = 0.f, sy = 0.f, sz = 0.f;
    float sxx = 0.f, sxy = 0.f, sxz = 0.f, syy = 0.f, syz = 0.f, szz = 0.f;
    float best_d2 = __int_as_float(0x7f800000);  // +inf
    int best_i = 0x7fffffff;
    auto accumulate = [&](float dx, float dy, float dz, int flat) {
      const float d2 = dist2(dx, dy, dz);
      if (!(d2 <= rr) || !(d2 <= r_eff2)) return;
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
      if (d2 < best_d2) {  // a lane visits its flat indices in order
        best_d2 = d2;
        best_i = flat;
      }
    };
#pragma unroll
    for (int b = 0; b < kCachedBatches; ++b) for_batch(kept[b], accumulate);
    walk(q, rest, accumulate);

    // ---- 5. the group's sums, handed to the epilogue lanes
    n = group_sum(gm, n);
    for (int s = kGroup / 2; s > 0; s >>= 1) {
      const float od = __shfl_xor_sync(gm, best_d2, s);
      const int oi = __shfl_xor_sync(gm, best_i, s);
      if (od < best_d2 || (od == best_d2 && oi < best_i)) {
        best_d2 = od;
        best_i = oi;
      }
    }
    const float sums[9] = {group_sum(gm, sx),  group_sum(gm, sy),
                           group_sum(gm, sz),  group_sum(gm, sxx),
                           group_sum(gm, sxy), group_sum(gm, sxz),
                           group_sum(gm, syy), group_sum(gm, syz),
                           group_sum(gm, szz)};
    if (gl == 0) {
      res[kN] = n;
      for (int i = 0; i < 9; ++i) res[kSx + i] = __float_as_int(sums[i]);
      res[kBestD2] = __float_as_int(best_d2);
      res[kBestI] = best_i;
      res[kReff2] = __float_as_int(r_eff2);
    }
  }
  __syncthreads();

  // ---- 6. the epilogue: lane e of the block's first warp takes its e-th
  // query (a warp runs kGroupsPerBlock eigensolves at once)
  const int e = threadIdx.x;
  if (e >= kGroupsPerBlock) return;
  const int qe = blockIdx.x * kGroupsPerBlock + e;
  if (qe >= m) return;
  const int* eres = smem + e * stride + 2 * n_off + 1 + 2 * kBins;
  const int* eslot = smem + e * stride + n_off + 1;
  const int n = eres[kN];
  const float sx = __int_as_float(eres[kSx]);
  const float sy = __int_as_float(eres[kSy]);
  const float sz = __int_as_float(eres[kSz]);
  const float so[3][3] = {
      {__int_as_float(eres[kSxx]), __int_as_float(eres[kSxy]),
       __int_as_float(eres[kSxz])},
      {__int_as_float(eres[kSxy]), __int_as_float(eres[kSyy]),
       __int_as_float(eres[kSyz])},
      {__int_as_float(eres[kSxz]), __int_as_float(eres[kSyz]),
       __int_as_float(eres[kSzz])}};
  const float best_d2 = __int_as_float(eres[kBestD2]);

  // closest point; with no candidate, argmin over all-inf picks flat index
  // 0: point 0 of candidate 0's slot (slot 0 where that voxel is absent)
  const int ci = n > 0 ? eres[kBestI] : 0;
  const int co = ci / p, cj = ci - co * p;
  const float* crow = points + static_cast<size_t>(eslot[co]) * (3 * p);
  out_closest[3 * qe + 0] = crow[cj];
  out_closest[3 * qe + 1] = crow[p + cj];
  out_closest[3 * qe + 2] = crow[2 * p + cj];
  out_closest_dist[qe] = n > 0 ? sqrtf(best_d2) : __int_as_float(0x7f800000);
  out_count[qe] = n;
  out_r_eff2[qe] = __int_as_float(eres[kReff2]);
  const float sr[3] = {sx, sy, sz};
  out_sum_rel[3 * qe + 0] = sx;
  out_sum_rel[3 * qe + 1] = sy;
  out_sum_rel[3 * qe + 2] = sz;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) out_sum_outer[9 * qe + 3 * a + b] = so[a][b];

  // ---- descriptor epilogue (description_from_moments)
  const float cs = fmaxf(static_cast<float>(n), 1.0f);
  float mean[3], cov[3][3];
  for (int a = 0; a < 3; ++a) mean[a] = sr[a] / cs;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) cov[a][b] = so[a][b] / cs - mean[a] * mean[b];
  const Eig eig = eigh3x3_normal(cov);
  const float s0 = fmaxf(fabsf(eig.vals[0]), 1e-20f);
  const float s1 = fabsf(eig.vals[1]), s2 = fabsf(eig.vals[2]);
  out_normal[3 * qe + 0] = eig.normal[0];
  out_normal[3 * qe + 1] = eig.normal[1];
  out_normal[3 * qe + 2] = eig.normal[2];
  out_a2d[qe] = (sqrtf(s1) - sqrtf(s2)) / sqrtf(s0);
}

}  // namespace

// points f32[C, 3P], slots / cnt_ok int32[M, O'] (K1's output on the same
// level), queries f32[M, 3]; radius f32[M] (each query's radius) or NULL
// (then rr, the squared scalar radius). k_nearest < 0: no shell cap (r_eff2
// = radius^2). cached_r_eff2 == NULL: compute the shell radius fresh.
extern "C" int k2_plane_moments(const void* points, const void* slots,
                                const void* cnt_ok, const void* queries,
                                int m, int n_off, int p, float rr,
                                const void* radius, int k_nearest,
                                const void* cached_r_eff2,
                                void* count, void* sum_rel, void* sum_outer,
                                void* closest, void* closest_dist,
                                void* r_eff2, void* normal, void* a2d,
                                void* stream) {
  if (m > 0) {
    const int blocks = (m + kGroupsPerBlock - 1) / kGroupsPerBlock;
    const int smem = static_cast<int>(sizeof(int)) * kGroupsPerBlock *
                     (2 * n_off + 1 + 2 * kBins + kResults);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          plane_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    plane_moments_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const int32_t*>(slots),
        static_cast<const int32_t*>(cnt_ok),
        static_cast<const float*>(queries), m, n_off, p, rr,
        static_cast<const float*>(radius), k_nearest,
        static_cast<const float*>(cached_r_eff2),
        static_cast<int32_t*>(count), static_cast<float*>(sum_rel),
        static_cast<float*>(sum_outer), static_cast<float*>(closest),
        static_cast<float*>(closest_dist), static_cast<float*>(r_eff2),
        static_cast<float*>(normal), static_cast<float*>(a2d));
  }
  return static_cast<int>(cudaGetLastError());
}

// the lanes per query this library was built with (K2_GROUP)
extern "C" int k2_group() { return kGroup; }
