// K15 prune_levels: tombstone the far voxels of every level of a map, in
// place, in one launch.
//
// Replaces ct_icp_tpu/mapping/voxel_map.py::prune_level (:596), the
// reference's RemoveElementsFarFromLocation (map.h:305-322), called there
// once a level: every occupied slot (key neither EMPTY nor TOMB) whose
// first point lies farther than max_distance from the location gets the
// TOMB key, count 0 and flag 0 (probe chains stay intact); the level's
// num_points drops by the points removed. With a gate (a device bool, the
// frame's assessment), nothing changes where it is false; the host reads
// nothing.
//
// One launch for all the levels of a frame, a thread a slot: the grid is
// the levels' blocks one after another (a level's first block in the
// argument struct), each level's tables and capacity in one argument
// struct, as K9 does (csrc/evict_voxels.cu). A thread reads its key first
// and the three planar words of the slot's first point (points[s][0], [P],
// [2P]) only where the slot is occupied. d2 is dx*dx + dy*dy + dz*dz, left
// to right in round-to-nearest intrinsics (the file is built with
// -fmad=false too), compared with the threshold max_distance^2 rounded as
// the plain version rounds it (a double product, then float32: the host
// passes it rounded), so the tombstones are the plain version's bit for
// bit. Each block sums the counts it removed (warp shuffles, then one
// integer atomicAdd into its level's per-device accumulator); the last
// block of the grid to finish (an acquire-release integer ticket) subtracts
// each level's total from its num_points and resets the accumulators and
// the ticket, so no call clears anything. Integer sums: the result does not
// depend on the order the blocks run in.
//
// Bound: bytes. Every slot's key read (4 B), each occupied slot's three
// first-point words (12 B, one sector each: planar rows put them 4P B
// apart), a tombstoned slot's key, count and flag written (12 B) and its
// count read (4 B); a few operations a slot. At the driving map's 2^18
// slots that is ~1 MB read for an empty map and ~4 MB for a full one.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;

struct Level {
  uint32_t* keys;
  int32_t* count;
  int32_t* nflags;
  int32_t* num_points;
  const float* points;   // f32 [cap, 3P], planar rows
  int p;                 // points a voxel
  int cap;               // slots
  int first_block;       // the level's first block of the grid
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

__global__ void __launch_bounds__(kThreads) prune_levels_kernel(
    const __grid_constant__ Levels levels, const float* __restrict__ location,
    float threshold, const uint8_t* __restrict__ gate,
    int32_t* __restrict__ scratch) {
  __shared__ int32_t warp_sums[kThreads / 32];
  __shared__ bool last;
  int li = 0;
  while (li + 1 < levels.count &&
         static_cast<int>(blockIdx.x) >= levels.lv[li + 1].first_block)
    ++li;
  const Level& L = levels.lv[li];
  const int s = (blockIdx.x - L.first_block) * kThreads + threadIdx.x;
  int32_t took = 0;
  if (s < L.cap && (gate == nullptr || gate[0] != 0)) {
    const uint32_t key = L.keys[s];
    if (key != cticp::kEmpty && key != cticp::kTomb) {
      const float* row = L.points + static_cast<size_t>(s) * (3 * L.p);
      const float dx = __fsub_rn(row[0], location[0]);
      const float dy = __fsub_rn(row[L.p], location[1]);
      const float dz = __fsub_rn(row[2 * L.p], location[2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 > threshold) {
        took = L.count[s];
        L.keys[s] = cticp::kTomb;
        L.count[s] = 0;
        L.nflags[s] = 0;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    took += __shfl_xor_sync(0xffffffffu, took, o);
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
  // the last block: a thread a level
  if (last && threadIdx.x < levels.count) {
    const int l = threadIdx.x;
    const int32_t total = atomicExch(scratch + l, 0);
    if (total != 0) levels.lv[l].num_points[0] -= total;
  }
  if (last && threadIdx.x == 0) scratch[kMaxLevels] = 0;
}

}  // namespace

// the block's threads and the most levels a launch takes
extern "C" int k15_threads() { return kThreads; }
extern "C" int k15_max_levels() { return kMaxLevels; }

// n_levels levels; for level l: keys / count / nflags int32[C_l],
// num_points int32[1], points f32[C_l, 3 P_l] (planar rows), first_block[l]
// its first block of the grid (kernels/prune_levels.py::layout), blocks the
// grid's; location f32[3] on the device; threshold max_distance^2 as
// float32; gate u8[1] on the device or null (always); scratch int32[9]
// (accumulators a level, the ticket), zero before the first call and left
// zero by every call.
extern "C" int k15_prune_levels(int n_levels, void* const* keys,
                                void* const* count, void* const* nflags,
                                void* const* num_points,
                                const void* const* points, const int* p,
                                const int* caps, const int* first_block,
                                int blocks, const void* location,
                                float threshold, const void* gate,
                                void* scratch, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  lv.count = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.lv[l] = {static_cast<uint32_t*>(keys[l]),
                static_cast<int32_t*>(count[l]),
                static_cast<int32_t*>(nflags[l]),
                static_cast<int32_t*>(num_points[l]),
                static_cast<const float*>(points[l]), p[l], caps[l],
                first_block[l]};
  }
  prune_levels_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(location), threshold,
      static_cast<const uint8_t*>(gate), static_cast<int32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
