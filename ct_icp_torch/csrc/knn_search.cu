// K12 knn_search: the bounded exact k-NN search of the map.
//
// Replaces ct_icp_tpu/mapping/voxel_map.py::radius_search (:917-937) over
// ::_candidate_planes (:821-842), the reference C++'s bounded priority queue
// (map.h:449-514): for each query, the k nearest live candidates with
// d2 <= radius^2, sorted by d2, ties to the lower flat index o * P + j (the
// order of jax.lax.top_k on -d2). The candidates are K1's over all O voxels:
// point j of candidate o is live for j < cnt_ok[q, o] and is read from the
// map at points[slots[q, o]][j], [P + j] and [2P + j]; the reference
// gathered an [M, O, 3P] copy of the rows first.
//
// A warp a query:
//   1. it loads the query's O (slot, cnt_ok) pairs into shared memory and
//      exclusive-scans the counts into live offsets (as K2 does);
//   2. lane l takes live candidates l, l + 32, l + 64, ... (a cursor steps
//      over the offsets to (o, j)), so a batch of 32 candidates is 32
//      consecutive flat indices;
//   3. the warp keeps its k best (d2, index) pairs sorted in shared memory
//      (at most kMaxK). A batch's in-radius candidates below the current
//      k-th distance are inserted one at a time, in lane order: the place is
//      a warp count of the kept d2 <= the candidate's (a later candidate
//      never beats an equal earlier one, so ties keep the lower index), and
//      the pairs after it move up one, kMaxK / 32 a lane. A query's whole
//      candidate set is never held: at O = 343 (the distance strategy's
//      nv = 3) a query may have 10,290 candidates;
//   4. the list out: the points re-read through the slots, sqrt(d2), and
//      the mask; past the list, zeros, +inf and false.
// d2 is dx*dx + dy*dy + dz*dz left to right, in round-to-nearest intrinsics
// (and the file is built with -fmad=false), so the in-radius test and the
// order are the plain version's bit for bit.
//
// Bound: bytes. Each distinct live candidate point read once (12 B), the
// (slot, cnt_ok) pairs (8 B), the queries and radii, the outputs (17 B a
// neighbour); the compares and the list's shifts are a few operations per
// byte.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxK = 128;
constexpr int kPerLane = kMaxK / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float x,
                                       float y, float z) {
  const float dx = __fsub_rn(x, qx);
  const float dy = __fsub_rn(y, qy);
  const float dz = __fsub_rn(z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock) knn_search_kernel(
    const float* __restrict__ points, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ cnt_ok, const float* __restrict__ queries,
    int m, int n_off, int p, float rr, const float* __restrict__ radius,
    int k, float* __restrict__ out_pts, uint8_t* __restrict__ out_mask,
    float* __restrict__ out_dist) {
  extern __shared__ int smem[];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarpsPerBlock + wib;
  if (qi >= m) return;  // the whole warp
  const int stride = 2 * n_off + 1 + 2 * k;
  int* off = smem + wib * stride;                        // [O + 1]
  int* slot = off + n_off + 1;                           // [O]
  float* ld = reinterpret_cast<float*>(slot + n_off);    // [k] kept d2
  int* li = reinterpret_cast<int*>(ld + k);              // [k] kept index
  const float inf = __int_as_float(0x7f800000);

  // ---- 1. the pairs, and the live offsets
  const int32_t* q_slots = slots + static_cast<size_t>(qi) * n_off;
  const int32_t* q_cnt = cnt_ok + static_cast<size_t>(qi) * n_off;
  for (int o = lane; o < n_off; o += 32) {
    slot[o] = q_slots[o];
    off[o] = q_cnt[o];
  }
  __syncwarp();
  int total = 0;
  for (int base = 0; base < n_off; base += 32) {
    const int o = base + lane;
    const int c = o < n_off ? off[o] : 0;
    int incl = c;
    for (int s = 1; s < 32; s <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += up;
    }
    if (o < n_off) off[o] = total + incl - c;
    total += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) off[n_off] = total;
  __syncwarp();

  const float qx = queries[3 * qi + 0];
  const float qy = queries[3 * qi + 1];
  const float qz = queries[3 * qi + 2];
  const float r2 =
      radius != nullptr ? __fmul_rn(radius[qi], radius[qi]) : rr;

  // ---- 2, 3. batches of 32 live candidates into the sorted list
  int n = 0;   // pairs kept (warp-uniform)
  int o = 0;   // the lane's cursor
  for (int base = 0; base < total; base += 32) {
    const int i = base + lane;
    float d2 = inf;
    int flat = 0;
    bool ok = false;
    if (i < total) {
      while (off[o + 1] <= i) ++o;
      const int j = i - off[o];
      const float* row = points + static_cast<size_t>(slot[o]) * (3 * p);
      d2 = dist2(qx, qy, qz, row[j], row[p + j], row[2 * p + j]);
      flat = o * p + j;
      ok = d2 <= r2;
    }
    const float thr = n < k ? inf : ld[k - 1];
    unsigned bits = __ballot_sync(kFull, ok && (n < k || d2 < thr));
    while (bits) {
      const int src = __ffs(bits) - 1;
      bits &= bits - 1u;
      const float cd = __shfl_sync(kFull, d2, src);
      const int ci = __shfl_sync(kFull, flat, src);
      if (n == k && !(cd < ld[k - 1])) continue;  // beaten in this batch
      int before = 0;
      for (int t = lane; t < n; t += 32) before += ld[t] <= cd ? 1 : 0;
      for (int s = 16; s > 0; s >>= 1)
        before += __shfl_xor_sync(kFull, before, s);
      const int last = n < k ? n : k - 1;  // pairs [before, last) move up
      float vd[kPerLane];
      int vi[kPerLane];
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int t = before + lane + 32 * u;
        if (t < last) {
          vd[u] = ld[t];
          vi[u] = li[t];
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int t = before + lane + 32 * u;
        if (t < last) {
          ld[t + 1] = vd[u];
          li[t + 1] = vi[u];
        }
      }
      if (lane == 0) {
        ld[before] = cd;
        li[before] = ci;
      }
      __syncwarp();
      n = n < k ? n + 1 : k;
    }
  }

  // ---- 4. the list out
  for (int t = lane; t < k; t += 32) {
    const size_t at = static_cast<size_t>(qi) * k + t;
    float* dst = out_pts + 3 * at;
    if (t < n) {
      const int f = li[t];
      const int oo = f / p;
      const int j = f - oo * p;
      const float* row = points + static_cast<size_t>(slot[oo]) * (3 * p);
      dst[0] = row[j];
      dst[1] = row[p + j];
      dst[2] = row[2 * p + j];
      out_mask[at] = 1;
      out_dist[at] = __fsqrt_rn(ld[t]);
    } else {
      dst[0] = dst[1] = dst[2] = 0.0f;
      out_mask[at] = 0;
      out_dist[at] = inf;
    }
  }
}

}  // namespace

// points f32[C, 3P], slots / cnt_ok int32[M, O] (K1's output over all O
// voxels of the same level), queries f32[M, 3]; radius f32[M] (each query's
// radius, squared here) or NULL (then rr, the squared scalar radius);
// 1 <= k <= kMaxK. Outputs: f32[M, k, 3], bool[M, k], f32[M, k].
extern "C" int k12_knn_search(const void* points, const void* slots,
                              const void* cnt_ok, const void* queries, int m,
                              int n_off, int p, float rr, const void* radius,
                              int k, void* out_pts, void* out_mask,
                              void* out_dist, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0) {
    const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const int smem = static_cast<int>(sizeof(int)) * kWarpsPerBlock *
                     (2 * n_off + 1 + 2 * k);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          knn_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    knn_search_kernel<<<blocks, 32 * kWarpsPerBlock, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const int32_t*>(slots),
        static_cast<const int32_t*>(cnt_ok),
        static_cast<const float*>(queries), m, n_off, p, rr,
        static_cast<const float*>(radius), k, static_cast<float*>(out_pts),
        static_cast<uint8_t*>(out_mask), static_cast<float*>(out_dist));
  }
  return static_cast<int>(cudaGetLastError());
}
