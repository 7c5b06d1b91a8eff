// K4 grid_sample: one representative point per voxel, in scan order.
//
// Replaces tools/pallas_kernels_experiment.py:35::dedup_compact (the Pallas
// claim-table sweep) and ct_icp_tpu/ops/sampling.py:27::
// voxel_subsample_indices (the XLA scatter-min it stands for). It computes
// what they compute, not the Pallas kernel's sequential sweep:
//
//   1. claim: every valid point hashes its truncated voxel coords (the
//      reference's 3-prime hash, masked to the 2^table_log2 table) and
//      atomicMins its claim word, this call's stamp over its scan index,
//      into its slot. The smallest index wins whatever the order the
//      threads arrive in, so distinct voxels that collide in the table merge
//      exactly as the reference's scatter-min merges them;
//   2. one grid barrier; a point is kept when its slot holds its own word
//      (the slot is derived again from the point, not stored); the kept
//      points are compacted in scan order (csrc/compact.cuh: each warp's
//      kept bits and a block scan of their counts in shared memory, a
//      second grid barrier, each block's offset; ranks at or past
//      `capacity` are dropped, idx and out_valid past min(kept, capacity),
//      the count, zeroed).
//
// One cooperative launch of resident blocks, each owning a run of
// 256-point tiles. The claim table persists per device and table size with
// a small control block (the last stamp): each call takes the next stamp,
// so words of earlier calls lose to every word of this one and no call
// clears the table; the table is cleared (all ones) inside the launch only
// by the call after the one that took stamp k4_stamp_limit(). Claim words
// are 32 bits, the stamp counted down in the high 15 bits over a 17-bit
// scan index: N is at most 2^17 (the path passes at most
// max_subsampled_points, 2^16), and the table is cleared once every 32,767
// calls. The persistent table costs 4 B a slot: 16.8 MB at table_log2 = 22
// (8.4 MB at 21), one per device and size used.
//
// Measured and removed (tools/exp_sample.py, H100 80GB HBM3 at 700 W;
// PERF.md): 64-bit claim words (a 32-bit stamp over a 32-bit index) took
// the same time and twice the memory; one block of 1,024 threads looping
// over the points with no grid barrier took 4.6x as long (one SM derives
// every voxel id); storing each point's slot at the claim instead of
// deriving it again saved nothing measurable and needs N ints of scratch.
//
// Bound: bytes. The function reads the points and their validity once
// (13 B a point) and writes idx, out_valid and the count (5 B a slot of the
// capacity, 4 B); the claim table is this design's scratch and is not
// counted (chip_smoke.py). With the table counted the floor would be its
// clear or its read, 16.8 MB. What sets the time is latency: the launch,
// the two grid barriers and the dependent claim-then-read of random words.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "compact.cuh"

namespace cg = cooperative_groups;

namespace {

using Word = unsigned int;
constexpr int kIdxBits = 17;
constexpr int kStampLimit = (1 << (32 - kIdxBits)) - 1;
// the high field all ones is a cleared word (stamp 0, never taken)
constexpr Word kHiMax = ~Word(0) >> kIdxBits;
constexpr int kMaxPoints = 1 << kIdxBits;

constexpr int kThreads = 256;
constexpr int kMaxTiles = 64;              // tiles of kThreads points a block
constexpr int kMaxBlocks = 8192;           // entries of the block counts

__device__ __forceinline__ Word claim_word(int stamp, int i) {
  return (static_cast<Word>(kHiMax - static_cast<Word>(stamp)) << kIdxBits) |
         static_cast<Word>(i);
}

__device__ __forceinline__ uint32_t point_slot(const float* __restrict__ pts,
                                               int i, float voxel,
                                               uint32_t mask) {
  const int cx = cticp::voxel_coord(pts[3 * i + 0], voxel);
  const int cy = cticp::voxel_coord(pts[3 * i + 1], voxel);
  const int cz = cticp::voxel_coord(pts[3 * i + 2], voxel);
  return cticp::voxel_hash_u32(cx, cy, cz) & mask;
}

// Mutable arrays shared across blocks (table, ctrl, block_cnt) carry no
// __restrict__/const and are read after a barrier through the L2 (__ldcg).
__global__ void __launch_bounds__(kThreads)
    grid_sample_kernel(const float* __restrict__ pts,
                       const uint8_t* __restrict__ valid, int n, float voxel,
                       uint32_t mask, int tiles_per_block, int capacity,
                       Word* table, int32_t* ctrl, int32_t* block_cnt,
                       int32_t* __restrict__ idx,
                       uint8_t* __restrict__ out_valid,
                       int32_t* __restrict__ count) {
  cg::grid_group grid = cg::this_grid();
  const int tile0 = blockIdx.x * tiles_per_block;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;

  // every block reads the last stamp before the first barrier
  int stamp = ctrl[0];
  if (stamp >= kStampLimit) {                  // every block agrees
    for (long long j = tid; j <= static_cast<long long>(mask); j += stride)
      table[j] = ~Word(0);
    stamp = 0;
    grid.sync();
  }
  ++stamp;

  // ---- 1. claim
  for (int t = 0; t < tiles_per_block; ++t) {
    const int i = (tile0 + t) * kThreads + threadIdx.x;
    if (i < n && valid[i]) {
      atomicMin(table + point_slot(pts, i, voxel, mask),
                claim_word(stamp, i));
    }
  }
  grid.sync();
  if (tid == 0) ctrl[0] = stamp;

  // ---- 2. the kept points (a slot holding the point's own word),
  // compacted in scan order: csrc/compact.cuh
  auto kept = [&](int i) {
    return valid[i] && __ldcg(table + point_slot(pts, i, voxel, mask)) ==
                           claim_word(stamp, i);
  };
  cticp::compact_in_scan_order<kThreads, kMaxTiles>(
      grid, kept, n, tiles_per_block, capacity, capacity, block_cnt, idx,
      out_valid, count);
}

int g_max_blocks = 0;   // blocks resident together: the cooperative limit

}  // namespace

// the last stamp before a call clears the table, the most points a call
// takes, and the int32 entries of the block counts
extern "C" int k4_stamp_limit() { return kStampLimit; }
extern "C" int k4_max_points() { return kMaxPoints; }
extern "C" int k4_block_ints() { return kMaxBlocks; }

// points: f32 [n, 3]; valid: u8 [n]; table: uint32 [2^table_log2] and
// ctrl: int32 [1], kept by the caller from call to call (table all ones,
// ctrl 0 at first); block_cnt: int32 [k4_block_ints()]; idx: int32
// [capacity], out_valid: u8 [capacity], count: int32 [1].
extern "C" int k4_grid_sample(const void* points, const void* valid, int n,
                              float voxel, int table_log2, int capacity,
                              void* table, void* ctrl, void* block_cnt,
                              void* idx, void* out_valid, void* count,
                              void* stream) {
  if (n < 0 || n > kMaxPoints || capacity < 0 || table_log2 < 2 ||
      table_log2 > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g_max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, grid_sample_kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_max_blocks = std::min(per_sm * sms, kMaxBlocks);
  }
  // each block owns a run of `tiles` tiles of kThreads points
  const int n_tiles = (n + kThreads - 1) / kThreads;
  int tiles = 0, blocks = 1;
  if (n_tiles > 0) {
    tiles = (n_tiles + g_max_blocks - 1) / g_max_blocks;
    blocks = (n_tiles + tiles - 1) / tiles;
  }
  if (tiles > kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(points);
  const auto* v = static_cast<const uint8_t*>(valid);
  uint32_t mask = static_cast<uint32_t>((1LL << table_log2) - 1);
  auto* tab = static_cast<Word*>(table);
  auto* ct = static_cast<int32_t*>(ctrl);
  auto* bc = static_cast<int32_t*>(block_cnt);
  auto* out = static_cast<int32_t*>(idx);
  auto* ov = static_cast<uint8_t*>(out_valid);
  auto* cnt = static_cast<int32_t*>(count);
  void* args[] = {&p, &v, &n, &voxel, &mask, &tiles, &capacity, &tab, &ct,
                  &bc, &out, &ov, &cnt};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(grid_sample_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
