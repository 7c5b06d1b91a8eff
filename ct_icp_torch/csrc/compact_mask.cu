// K16 compact_mask: a stable compaction of a bool mask into the indices of
// its set entries, in scan order.
//
// Replaces ct_icp_tpu/ops/voxel.py::compact_mask (:55), the XLA prefix sum
// and scatter: idx int32[capacity] holds the positions i with mask[i], in
// increasing order, the first `capacity` of them; count = min(set entries,
// capacity); out_valid[j] = j < count; idx past the count is 0. On the card
// it is reached from pipeline.device_decimation (the device sub-sample path
// and the device keypoint election with a residual cap); K4 and K13 carry
// the same compaction inside their own launches.
//
// One cooperative launch on csrc/compact.cuh's scan-order compaction (the
// code K4 and K13 end with): block b owns tiles [b * tiles, (b + 1) *
// tiles) of 256 entries; each warp's set bits go to shared memory by ballot
// and a block scan ranks them; one grid barrier; each block sums the counts
// of the blocks before it, places its entries at their rank (those at or
// past `capacity` dropped) and zeroes idx and out_valid past the count up
// to the capacity. Integer ranks: the result does not depend on the order
// the blocks run in, and it is the plain version's bit for bit.
//
// Bound: bytes. The mask read once (1 B an entry) and the outputs written
// once (5 B a slot of the capacity, 4 B of count); no arithmetic to speak
// of. At the decimation's sizes (a few thousand entries) the launch, the
// grid barrier and the dependent read of the block counts set the time.
#include <cooperative_groups.h>

#include <algorithm>

#include "compact.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 64;       // tiles of kThreads entries a block
constexpr int kMaxBlocks = 8192;    // entries of the block counts

__global__ void __launch_bounds__(kThreads)
    compact_mask_kernel(const uint8_t* __restrict__ mask, int n,
                        int tiles_per_block, int capacity, int32_t* block_cnt,
                        int32_t* __restrict__ idx,
                        uint8_t* __restrict__ out_valid,
                        int32_t* __restrict__ count) {
  cg::grid_group grid = cg::this_grid();
  auto kept = [&](int i) { return mask[i] != 0; };
  cticp::compact_in_scan_order<kThreads, kMaxTiles>(
      grid, kept, n, tiles_per_block, capacity, capacity, block_cnt, idx,
      out_valid, count);
}

}  // namespace

// the block's threads, the most tiles a block takes, the int32 entries of
// the block counts
extern "C" int k16_threads() { return kThreads; }
extern "C" int k16_max_tiles() { return kMaxTiles; }
extern "C" int k16_block_ints() { return kMaxBlocks; }

// Blocks of the kernel resident on the current device at once (the
// cooperative launch's limit), or a negative cudaError.
extern "C" int k16_resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, compact_mask_kernel, kThreads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return std::min(per_sm * sms, kMaxBlocks);
}

// mask: u8 [n]; `blocks` blocks of `tiles` tiles of kThreads entries each
// (kernels/compact_mask.py::layout: blocks * tiles * kThreads >= n, blocks
// at most k16_resident_blocks(), tiles at most kMaxTiles); block_cnt:
// int32 [k16_block_ints()] scratch; idx: int32 [capacity], out_valid: u8
// [capacity], count: int32 [1].
extern "C" int k16_compact_mask(const void* mask, int n, int tiles,
                                int blocks, int capacity, void* block_cnt,
                                void* idx, void* out_valid, void* count,
                                void* stream) {
  if (n < 0 || capacity < 0 || tiles < 0 || tiles > kMaxTiles ||
      blocks < 1 || blocks > kMaxBlocks ||
      static_cast<long long>(blocks) * tiles * kThreads < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* bc = static_cast<int32_t*>(block_cnt);
  auto* out = static_cast<int32_t*>(idx);
  auto* ov = static_cast<uint8_t*>(out_valid);
  auto* cnt = static_cast<int32_t*>(count);
  void* args[] = {&m, &n, &tiles, &capacity, &bc, &out, &ov, &cnt};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(compact_mask_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
