// The scan-order compaction that ends K4 grid_sample and K13 exact_sample
// (the device half of ct_icp_tpu/ops/voxel.py::compact_mask): inside one
// cooperative launch whose block b owns tiles [b * tiles, (b + 1) * tiles)
// of kThreads points, each warp's kept bits and a block scan of their
// counts go to shared memory and the block's total to block_cnt; after a
// grid barrier each block sums the totals of the blocks before it and of
// all of them and places its kept indices at their rank, cut at `cut`;
// idx and out_valid past min(kept, cut) are zeroed up to the capacity.
#pragma once
#include <cooperative_groups.h>

#include <cstdint>

namespace cticp {

// In place: v[0..m) becomes its exclusive prefix sums; returns the total.
// Every thread of the block calls it; tmp holds kThreads / 32 + 1 ints.
template <int kThreads>
__device__ int block_exclusive_scan(int* v, int m, int* tmp) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (m + kThreads - 1) / kThreads;
  const int b0 = threadIdx.x * per;
  int own = 0;
  for (int k = 0; k < per; ++k)
    if (b0 + k < m) own += v[b0 + k];
  int incl = own;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < kWarps ? tmp[lane] : 0;
    int xi = x;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, xi, d);
      if (lane >= d) xi += up;
    }
    if (lane < kWarps) tmp[lane] = xi - x;
    if (lane == 31) tmp[kWarps] = xi;
  }
  __syncthreads();
  int run = tmp[warp] + incl - own;
  for (int k = 0; k < per; ++k) {
    if (b0 + k < m) {
      const int c = v[b0 + k];
      v[b0 + k] = run;
      run += c;
    }
  }
  const int total = tmp[kWarps];
  __syncthreads();
  return total;
}

// kept(i) says whether point i (< n) is kept; every thread of the grid
// calls this once, after which *count = min(kept points, cut). block_cnt
// (gridDim.x ints) is written before the barrier and read after it through
// the L2.
template <int kThreads, int kMaxTiles, typename Kept>
__device__ void compact_in_scan_order(cooperative_groups::grid_group& grid,
                                      Kept kept, int n, int tiles_per_block,
                                      int cut, int capacity,
                                      int32_t* block_cnt,
                                      int32_t* __restrict__ idx,
                                      uint8_t* __restrict__ out_valid,
                                      int32_t* __restrict__ count) {
  constexpr int kWarps = kThreads / 32;
  __shared__ unsigned bits[kMaxTiles * kWarps];
  __shared__ int prefix[kMaxTiles * kWarps];
  __shared__ int tmp[2 * kWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile0 = blockIdx.x * tiles_per_block;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;

  // kept bits by warp and tile, their counts scanned in the block
  for (int t = 0; t < tiles_per_block; ++t) {
    const int i = (tile0 + t) * kThreads + threadIdx.x;
    const unsigned b = __ballot_sync(0xffffffffu, i < n && kept(i));
    if (lane == 0) {
      bits[t * kWarps + warp] = b;
      prefix[t * kWarps + warp] = __popc(b);
    }
  }
  __syncthreads();
  const int block_total =
      block_exclusive_scan<kThreads>(prefix, tiles_per_block * kWarps, tmp);

  // the block's offset and the total, then the scatter and the fill
  if (threadIdx.x == 0) block_cnt[blockIdx.x] = block_total;
  grid.sync();
  int before = 0, total = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    const int c = __ldcg(block_cnt + b);
    total += c;
    if (b < static_cast<int>(blockIdx.x)) before += c;
  }
  for (int d = 16; d > 0; d >>= 1) {
    before += __shfl_down_sync(0xffffffffu, before, d);
    total += __shfl_down_sync(0xffffffffu, total, d);
  }
  if (lane == 0) {
    tmp[warp] = before;
    tmp[kWarps + warp] = total;
  }
  __syncthreads();
  before = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += tmp[w];
    total += tmp[kWarps + w];
  }
  for (int t = 0; t < tiles_per_block; ++t) {
    const unsigned b = bits[t * kWarps + warp];
    if ((b >> lane) & 1u) {
      const int pos = before + prefix[t * kWarps + warp] +
                      __popc(b & ((1u << lane) - 1u));
      if (pos < cut) {
        idx[pos] = (tile0 + t) * kThreads + threadIdx.x;
        out_valid[pos] = 1;
      }
    }
  }
  const int cnt = total < cut ? total : cut;
  for (long long j = tid + cnt; j < capacity; j += stride) {
    idx[j] = 0;
    out_valid[j] = 0;
  }
  if (tid == 0) *count = cnt;
}

}  // namespace cticp
