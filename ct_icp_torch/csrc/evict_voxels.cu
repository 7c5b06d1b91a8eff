// K9 evict_voxels: empty the listed voxels of every level of a map, in
// place, in one launch.
//
// Replaces ct_icp_tpu/mapping/voxel_map.py::evict_voxels (:564-593), called
// once a level by the backend replay (odometry.py::replay_refined_frames):
// each listed coordinate is looked up (K1's probe, csrc/probe.cuh); where
// the voxel is present its count and normal flag drop to 0 and its key
// stays, so probe chains stay intact and a later insert of the voxel
// refills the same slot. Each level's num_points drops by the points
// removed, which the call also returns (a level each, then their total).
// The reference's probe window (``win``) is TPU layout and the port has
// none, so nothing is rebuilt.
//
// One launch for all the levels of a replay, a thread a coordinate: the
// grid is the levels' blocks one after another (a level's first block in
// the argument struct, so no block of the grid is idle); each level's
// tables, coordinates and row count come in one argument struct, so a
// level's rows past its count (the padding) are never read and need no
// mask (a single-level call may pass one). The
// count is taken by atomicExch, so a slot listed twice is emptied once and
// counted once; each block sums what its threads removed (warp shuffles,
// then one integer atomicAdd into its level's per-device accumulator); the
// last block of the grid to finish (an integer ticket)
// subtracts each level's total from its num_points, writes the totals and
// resets the accumulators and the ticket, so no call clears anything and
// the host reads nothing. The ticket is an acquire-release atomic, which
// orders the block's sum before it without a full fence. Integer sums: the
// result does not depend on the order the blocks run in.
//
// Bound: bytes. For each listed coordinate its 12 B (and its valid flag
// where a mask is passed) and the probed 16 B key window; for each found
// slot its count read and its count and flag written; no arithmetic to
// speak of (two hashes and a compare chain a coordinate). One launch is
// below a microsecond of that at a replay's sizes: the launch's own floor
// (an empty kernel of the same grid, k9_empty) and the chain of one
// coordinate (coordinates, key window, exchange) and of the last block
// (ticket, the level totals) are what it takes.
#include "common.cuh"
#include "probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;

struct Level {
  const uint32_t* keys;
  int32_t* count;
  int32_t* nflags;
  int32_t* num_points;
  const int32_t* coords;   // int32 [rows, 3]
  const uint8_t* valid;    // uint8 [rows] or null: every row below n
  int n;                   // rows read
  uint32_t cap_mask;       // C - 1
  int first_block;         // the level's first block of the grid
};

struct Levels {
  Level lv[kMaxLevels];
  int count;
};

__device__ __forceinline__ int ticket(int32_t* p) {
  int32_t old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(1)
               : "memory");
  return old;
}

__global__ void __launch_bounds__(kThreads) evict_voxels_kernel(
    const __grid_constant__ Levels levels, int32_t* __restrict__ scratch,
    int32_t* __restrict__ removed) {
  __shared__ int32_t warp_sums[kThreads / 32];
  __shared__ bool last;
  int li = 0;
  while (li + 1 < levels.count &&
         static_cast<int>(blockIdx.x) >= levels.lv[li + 1].first_block)
    ++li;
  const Level& L = levels.lv[li];
  const int i = (blockIdx.x - L.first_block) * kThreads + threadIdx.x;
  int32_t took = 0;
  if (i < L.n && (L.valid == nullptr || L.valid[i])) {
    const int slot = cticp::probe_slot(L.keys, L.cap_mask, L.coords[3 * i + 0],
                                       L.coords[3 * i + 1],
                                       L.coords[3 * i + 2]);
    if (slot >= 0) {
      took = atomicExch(L.count + slot, 0);
      L.nflags[slot] = 0;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    took += __shfl_xor_sync(0xffffffffu, took, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = took;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t block = 0;
    for (int w = 0; w < kThreads / 32; ++w) block += warp_sums[w];
    if (block != 0) atomicAdd(scratch + li, block);
    last = ticket(scratch + kMaxLevels) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  // the last block: a thread a level, then the total
  if (last && threadIdx.x < levels.count) {
    const int l = threadIdx.x;
    const int32_t total = atomicExch(scratch + l, 0);
    removed[l] = total;
    levels.lv[l].num_points[0] -= total;
    warp_sums[l] = total;
  }
  if (last) {
    __syncwarp();
    if (threadIdx.x == 0) {
      int32_t all = 0;
      for (int l = 0; l < levels.count; ++l) all += warp_sums[l];
      removed[levels.count] = all;
      scratch[kMaxLevels] = 0;
    }
  }
}

// The floor of a launch (tools/exp_evict.py, chip_smoke.py): no work.
__global__ void empty_kernel() {}

}  // namespace

// An empty kernel on a grid of `blocks` CTAs of the eviction's block size:
// what any launch of that shape costs.
extern "C" int k9_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// n_levels levels; for level l: keys / count / nflags int32[C_l] (C_l a
// power of two >= 8, keys 16-byte aligned), num_points int32[1], coords
// int32[>= n_l, 3], valid uint8[>= n_l] or null, n_l the rows read, caps
// the C_l. Each pointer array holds n_levels entries. scratch int32[9]
// (accumulators a level, the ticket), zero before the first call and left
// zero by every call; removed int32[n_levels + 1] out (a level each, then
// the total).
extern "C" int k9_evict_voxels(int n_levels, void* const* keys,
                               void* const* count, void* const* nflags,
                               void* const* num_points,
                               const void* const* coords,
                               const void* const* valid, const int* n,
                               const int* caps, void* scratch, void* removed,
                               void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  lv.count = n_levels;
  int blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.lv[l] = {static_cast<const uint32_t*>(keys[l]),
                static_cast<int32_t*>(count[l]),
                static_cast<int32_t*>(nflags[l]),
                static_cast<int32_t*>(num_points[l]),
                static_cast<const int32_t*>(coords[l]),
                static_cast<const uint8_t*>(valid[l]), n[l],
                static_cast<uint32_t>(caps[l] - 1), blocks};
    blocks += n[l] > 0 ? (n[l] + kThreads - 1) / kThreads : 0;
  }
  blocks = blocks > 0 ? blocks : 1;   // the last block writes the totals
  evict_voxels_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<int32_t*>(scratch), static_cast<int32_t*>(removed));
  return static_cast<int>(cudaGetLastError());
}
