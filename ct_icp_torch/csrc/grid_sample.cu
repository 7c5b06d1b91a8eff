// K4 grid_sample: one representative point per voxel, in scan order.
//
// Replaces tools/pallas_kernels_experiment.py:35::dedup_compact (the Pallas
// claim-table sweep) and ct_icp_tpu/ops/sampling.py:27::
// voxel_subsample_indices (the XLA scatter-min it stands for). It computes
// what they compute, not the Pallas kernel's sequential sweep:
//
//   1. clear the claim table (2^table_log2 int32 slots) to INT_MAX;
//   2. hash every valid point's truncated voxel coords (the reference's
//      3-prime hash, masked to the table) and atomicMin its scan index into
//      its slot: the winner is the smallest index, whatever the order the
//      threads arrive in, so distinct voxels that collide in the table merge
//      exactly as the reference's scatter-min merges them;
//   3. a point is kept when its slot holds its own index;
//   4. stable compaction in scan order: a per-block count, one scan of the
//      block counts, then a block-local ballot scan that places each kept
//      index at its rank; ranks at or past `capacity` are dropped and the
//      count is min(kept, capacity).
//
// Five launches, no host sync, no float atomics. Bound: bytes. Clearing the
// table dominates them (16.8 MB at table_log2 = 22, about 5 us at
// 3.35 TB/s); the points (12 B each) and the outputs are small beside it.
// A stamped table, cleared once and reused with a per-call stamp as K3
// does, would remove the clear; that is later work.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;   // threads per block of the scan passes

__global__ void gs_clear(int32_t* __restrict__ table, long long t,
                         int32_t* __restrict__ idx, int capacity) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long end = t > capacity ? t : capacity;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < end; i += stride) {
    if (i < t) table[i] = INT_MAX;
    if (i < capacity) idx[i] = 0;
  }
}

__global__ void gs_claim(const float* __restrict__ pts,
                         const uint8_t* __restrict__ valid, int n, float voxel,
                         uint32_t mask, int32_t* __restrict__ table,
                         int32_t* __restrict__ slot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {
    slot[i] = -1;
    return;
  }
  const int cx = cticp::voxel_coord(pts[3 * i + 0], voxel);
  const int cy = cticp::voxel_coord(pts[3 * i + 1], voxel);
  const int cz = cticp::voxel_coord(pts[3 * i + 2], voxel);
  const uint32_t h = cticp::voxel_hash_u32(cx, cy, cz) & mask;
  slot[i] = static_cast<int32_t>(h);
  atomicMin(table + h, i);
}

__device__ __forceinline__ bool gs_kept(const int32_t* __restrict__ slot,
                                        const int32_t* __restrict__ table,
                                        int n, int i) {
  if (i >= n) return false;
  const int32_t s = slot[i];
  return s >= 0 && table[s] == i;
}

__global__ void gs_count(const int32_t* __restrict__ slot,
                         const int32_t* __restrict__ table, int n,
                         int32_t* __restrict__ block_cnt) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int c = __syncthreads_count(gs_kept(slot, table, n, i));
  if (threadIdx.x == 0) block_cnt[blockIdx.x] = c;
}

// one thread: exclusive scan of the block counts (in place), then the
// capped total
__global__ void gs_scan(int32_t* __restrict__ block_cnt, int nblocks,
                        int capacity, int32_t* __restrict__ count) {
  int run = 0;
  for (int b = 0; b < nblocks; ++b) {
    const int c = block_cnt[b];
    block_cnt[b] = run;
    run += c;
  }
  *count = run < capacity ? run : capacity;
}

__global__ void gs_scatter(const int32_t* __restrict__ slot,
                           const int32_t* __restrict__ table, int n,
                           int n_blocks, const int32_t* __restrict__ block_off,
                           const int32_t* __restrict__ count, int capacity,
                           int32_t* __restrict__ idx,
                           uint8_t* __restrict__ out_valid) {
  __shared__ int warp_off[kBlock / 32];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool kept = gs_kept(slot, table, n, i);
  const unsigned bits = __ballot_sync(0xffffffffu, kept);
  if (lane == 0) warp_off[warp] = __popc(bits);
  __syncthreads();
  if (warp == 0) {
    const int own = warp_off[lane];
    int v = own;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += up;
    }
    warp_off[lane] = v - own;   // exclusive prefix over the warps
  }
  __syncthreads();
  if (kept && blockIdx.x < n_blocks) {
    const int pos = block_off[blockIdx.x] + warp_off[warp] +
                    __popc(bits & ((1u << lane) - 1u));
    if (pos < capacity) idx[pos] = i;
  }
  if (i < capacity) out_valid[i] = i < *count ? 1 : 0;
}

}  // namespace

extern "C" int k4_grid_sample(const void* points, const void* valid, int n,
                              float voxel, int table_log2, int capacity,
                              void* table, void* slot, void* block_cnt,
                              void* idx, void* out_valid, void* count,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long t = 1LL << table_log2;
  auto* tab = static_cast<int32_t*>(table);
  auto* sl = static_cast<int32_t*>(slot);
  auto* bc = static_cast<int32_t*>(block_cnt);
  auto* cnt = static_cast<int32_t*>(count);
  auto* out = static_cast<int32_t*>(idx);
  auto* ov = static_cast<uint8_t*>(out_valid);

  gs_clear<<<1024, 256, 0, s>>>(tab, t, out, capacity);
  const int nb = (n + kBlock - 1) / kBlock;
  if (n > 0) {
    gs_claim<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(points), static_cast<const uint8_t*>(valid),
        n, voxel, static_cast<uint32_t>(t - 1), tab, sl);
    gs_count<<<nb, kBlock, 0, s>>>(sl, tab, n, bc);
  }
  gs_scan<<<1, 1, 0, s>>>(bc, nb, capacity, cnt);
  const int cap_blocks = (capacity + kBlock - 1) / kBlock;
  const int grid = nb > cap_blocks ? nb : cap_blocks;
  if (grid > 0) {
    gs_scatter<<<grid, kBlock, 0, s>>>(sl, tab, n, nb, bc, cnt, capacity, out,
                                       ov);
  }
  return static_cast<int>(cudaGetLastError());
}
