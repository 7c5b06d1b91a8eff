// K7 rebuild_claim: the hash-table half of the floating-origin map rebase.
//
// Replaces the table rebuild of ct_icp_tpu/mapping/voxel_map.py::
// rebuild_level (:619-640, and its num_points, :656): for every row with
// keys > TOMB and count > 0, subtract the shift from the row's first point
// (x, y, z at columns 0, P and 2P, _first_point :133), re-derive its voxel
// (truncf(x / v), built with -fmad=false as K3), its 3-prime probe hash and
// identity key, claim a slot for it in a fresh table with the insert's claim
// rounds (claim.cuh, shared with K3: MAX_PROBES = 16 rounds, atomicMin of
// the ROW index, losers re-read, so rows with equal keys resolve to one
// slot), then elect each slot's writer: src[slot] = the largest row index
// resolved to it (the reference's scatter-max of the row index, :636-639),
// -1 where no row landed; num_points = the sum of the writers' counts. K6
// row_gather then moves the rows: out[s] = rows[src[s]] - shift.
//
// Rows that merge near the origin (two voxels' first points truncating to
// one voxel id after the shift) resolve to one slot and only the writer's
// row survives; rows still unresolved after 16 rounds are dropped, as the
// reference drops them.
//
// One cooperative launch (K3's structure: grid-stride loops, a grid barrier
// between phases) of 1,024-thread blocks, as many as are resident but at
// most two an SM: the barriers, not the memory, set the time, and a barrier
// costs less the fewer blocks it joins:
//   0. clear: the fresh table to EMPTY, src to -1, the claim words to all
//      ones, the counters and num_points to 0;
//   1. derive: each occupied row's voxel, hash and key, appended with its
//      row index and count to a compact claimant list (the claimant rows
//      of claim.cuh are indexed by the place in the list, so a round's
//      loads are coalesced) and round 0's claim made (on the fresh table
//      every home slot is EMPTY); four rows a thread at once, so their
//      loads overlap;
//   2. the claim rounds of claim.cuh over that list only, two barriers a
//      round: round r's winners write their keys | round r + 1's re-read
//      and probe, counting the claimants still unresolved into the round's
//      own counter, which every block reads after the barrier, so every
//      block leaves the loop at the same barrier (all resolved, or 16
//      rounds);
//   (the list's places and the counters are taken one atomic a block, a
//   block scan placing its threads: per warp, thousands of atomics on one
//   word would serialise);
//   3. election: atomicMax(src + slot, row) for each resolved claimant;
//   4. num_points: each block sums the counts of the claimants that won
//      their slot's election (exact int32).
// The claim word keeps the ORIGINAL row index, so the list's order changes
// nothing and the arbitration stays the reference's scatter-min. The rounds
// run are added to a device counter (read by the measurement scripts only).
//
// Bound: bytes, every key read and every table and src slot written (12 B
// a slot), the count of each row with a live key (4 B) and the first point
// of each occupied row (12 B). The grid barriers set the time: 3 + 2 per
// claim round run.
#include <cooperative_groups.h>

#include <algorithm>

#include "claim.cuh"

namespace cg = cooperative_groups;

namespace {

// measurement variants (tools/exp_rebase.py; the main build takes the
// defaults): the block size, the blocks an SM (fewer than resident), and
// the phases run (1: the clear, 2: + derive, 3: + claim rounds, 4: +
// election, 5: all)
#ifndef K7_THREADS
#define K7_THREADS 1024
#endif
#ifndef K7_BLOCKS_PER_SM
#define K7_BLOCKS_PER_SM 2
#endif
#ifndef K7_PHASES
#define K7_PHASES 5
#endif
constexpr int kThreads = K7_THREADS;
constexpr int kBlocksPerSm = K7_BLOCKS_PER_SM;
constexpr int kItems = 4;   // rows a thread derives at once
// control block (int32, cleared by phase 0): the claimant count, then the
// live claimants after each round
constexpr int kNClaim = 0, kLive = 1,
              kCtrlInts = kLive + cticp::kMaxProbes + 1;
static_assert(kCtrlInts <= kThreads, "one block clears the control block");

using cticp::kResolved;
using cticp::kValid;

constexpr int kWarps = kThreads / 32;
static_assert(kWarps <= 32, "one warp scans the block's warps");

// Exclusive prefix of each warp's `n` over the block's warps, and the block
// total added to `counter` by one atomic: returns the counter's old value
// plus the prefix of the calling warp. Every thread of the block calls it
// (with its warp's n, the same on every lane); `sh`: kWarps + 1 ints.
__device__ __forceinline__ int block_reserve(int32_t* counter, int n,
                                             int* sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh[warp] = n;
  __syncthreads();
  if (warp == 0) {
    const int mine = lane < kWarps ? sh[lane] : 0;
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int base = 0;
    if (lane == 31 && incl > 0) base = atomicAdd(counter, incl);
    base = __shfl_sync(0xffffffffu, base, 31);
    if (lane < kWarps) sh[lane] = base + incl - mine;
  }
  __syncthreads();
  const int at = sh[warp];
  __syncthreads();       // sh is free for the next call
  return at;
}

// Add the sum of every thread's `mine` over the block to `counter`, one
// atomic a block. Every thread of the block calls it.
__device__ __forceinline__ void block_count(int32_t* counter, int mine,
                                            int* sh) {
  const int n = __reduce_add_sync(0xffffffffu, mine);
  block_reserve(counter, n, sh);
}

// The table, src, the claim words, the claimant rows and the control block
// are written and read inside the launch: no __restrict__ or const on them,
// so no block reads another's writes through the read-only cache. The
// level's keys, counts and points and the shift are read only.
__global__ void __launch_bounds__(kThreads)
    rebuild_claim_kernel(const uint32_t* __restrict__ keys,
                         const int32_t* __restrict__ count,
                         const float* __restrict__ points,
                         const float* __restrict__ shift, int c, int p,
                         float resolution, uint32_t* table, int32_t* src,
                         cticp::ClaimRows s, int32_t* row, int32_t* row_count,
                         unsigned long long* claim, int32_t* ctrl,
                         int32_t* num_points, int32_t* rounds) {
  __shared__ int sh[kWarps + 1];
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads;
  const int tid = first + threadIdx.x;
  const uint32_t cap_mask = static_cast<uint32_t>(c - 1);

  // ---- 0. clear
  for (int i = tid; i < c; i += stride) {
    table[i] = cticp::kEmpty;
    src[i] = -1;
    claim[i] = ~0ull;
  }
  if (blockIdx.x == 0 && threadIdx.x < kCtrlInts) ctrl[threadIdx.x] = 0;
  if (tid == 0) *num_points = 0;
  grid.sync();
  if (K7_PHASES < 2) return;

  // ---- 1. derive; append the claimants; claim round 0's probe. A thread
  // takes kItems rows at once, so their loads are in flight together (keys
  // and counts, then the first points of the occupied rows). Round 0 finds
  // the fresh table EMPTY at every slot, so each claimant claims its home
  // slot without reading the table.
  for (int base = first; base < c; base += kItems * stride) {
    int n[kItems];
    bool claimant[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + j * stride + threadIdx.x;
      const uint32_t k = i < c ? keys[i] : cticp::kEmpty;
      n[j] = i < c ? count[i] : 0;
      claimant[j] = k != cticp::kEmpty && k != cticp::kTomb && n[j] > 0;
    }
    float x[kItems][3];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (!claimant[j]) continue;
      const int i = base + j * stride + threadIdx.x;
      const float* pt = points + static_cast<size_t>(i) * 3 * p;
      x[j][0] = pt[0];
      x[j][1] = pt[p];
      x[j][2] = pt[2 * p];
    }
    // the claimants' places in the list: warp by warp, item by item, one
    // atomic a block
    const int lane = threadIdx.x & 31;
    unsigned want[kItems];
    int warp_n = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      want[j] = __ballot_sync(0xffffffffu, claimant[j]);
      warp_n += __popc(want[j]);
    }
    int e = block_reserve(ctrl + kNClaim, warp_n, sh);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int at = e + __popc(want[j] & ((1u << lane) - 1u));
      e += __popc(want[j]);
      if (!claimant[j]) continue;
      const int i = base + j * stride + threadIdx.x;
      const int cx = cticp::voxel_coord(x[j][0] - shift[0], resolution);
      const int cy = cticp::voxel_coord(x[j][1] - shift[1], resolution);
      const int cz = cticp::voxel_coord(x[j][2] - shift[2], resolution);
      const uint32_t h = cticp::voxel_hash_u32(cx, cy, cz);
      s.hash[at] = h;
      s.key[at] = cticp::voxel_key_u32(cx, cy, cz);
      s.slot[at] = -1;
      s.attempt[at] = 0;
      s.flags[at] = kValid;
      row[at] = i;
      row_count[at] = n[j];
      atomicMin(claim + (h & cap_mask), cticp::claim_word(0, i));
    }
  }
  grid.sync();
  if (K7_PHASES < 3) return;

  // ---- 2. claim rounds over the list; stop once none is left unresolved
  // (stamp r for round r: the claim words were cleared in phase 0)
  const int n_claim = ctrl[kNClaim];
  int live = n_claim;
  int r = 0;
  for (; live > 0 && r < cticp::kMaxProbes; ++r) {
    for (int e = tid; e < n_claim; e += stride)
      cticp::claim_write(table, claim, e, row[e], cap_mask, r, r, s);
    grid.sync();
    int still = 0;
    for (int e = tid; e < n_claim; e += stride)
      if (s.flags[e] == kValid)
        still += cticp::claim_attempt(table, claim, e, row[e], cap_mask,
                                      r + 1, r + 1, s) &&
                 s.flags[e] == kValid;
    block_count(ctrl + kLive + r + 1, still, sh);
    grid.sync();
    live = ctrl[kLive + r + 1];
  }
  if (K7_PHASES < 4) {
    if (tid == 0) atomicAdd(rounds, r);
    return;
  }

  // ---- 3. elect each slot's writer: the largest row resolved to it
  for (int e = tid; e < n_claim; e += stride)
    if (s.flags[e] & kResolved) atomicMax(src + s.slot[e], row[e]);
  grid.sync();
  if (K7_PHASES < 5) return;

  // ---- 4. num_points: the counts of the writers, one atomic a block
  int sum = 0;
  for (int e = tid; e < n_claim; e += stride)
    if ((s.flags[e] & kResolved) && src[s.slot[e]] == row[e])
      sum += row_count[e];
  block_count(num_points, sum, sh);
  if (tid == 0) atomicAdd(rounds, r);
}

int g_max_blocks = 0;   // blocks resident together: the cooperative limit

}  // namespace

// keys (uint32 bits), count: int32 [c]; points: f32 [c, 3p]; shift: f32 [3]
// on the device. Writes table: uint32 [c] (the fresh keys), src: int32 [c]
// and num_points: int32 [1], and adds the claim rounds run to rounds: int32
// [1]. scratch: int32 [7 * c]; claim: uint64 [c]; ctrl: int32
// [k7_ctrl_ints()]. One cooperative launch; a refused launch returns its
// error.
extern "C" int k7_ctrl_ints() { return kCtrlInts; }

extern "C" int k7_rebuild_claim(const void* keys, const void* count,
                                const void* points, const void* shift,
                                int c, int p, float resolution, void* table,
                                void* src, void* num_points, void* scratch,
                                void* claim, void* ctrl, void* rounds,
                                void* stream) {
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (g_max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rebuild_claim_kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_max_blocks = std::min(per_sm, kBlocksPerSm) * sms;
  }
  int32_t* sc = static_cast<int32_t*>(scratch);
  cticp::ClaimRows s{sc, reinterpret_cast<uint32_t*>(sc + c),
                     reinterpret_cast<uint32_t*>(sc + 2 * c), sc + 3 * c,
                     sc + 4 * c};
  int32_t* row = sc + 5 * c;
  int32_t* row_count = sc + 6 * c;
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* cnt = static_cast<const int32_t*>(count);
  const auto* pts = static_cast<const float*>(points);
  const auto* sh = static_cast<const float*>(shift);
  auto* tb = static_cast<uint32_t*>(table);
  auto* sr = static_cast<int32_t*>(src);
  auto* cl = static_cast<unsigned long long*>(claim);
  auto* ct = static_cast<int32_t*>(ctrl);
  auto* np = static_cast<int32_t*>(num_points);
  auto* rd = static_cast<int32_t*>(rounds);
  void* args[] = {&k, &cnt, &pts, &sh, &c, &p, &resolution, &tb, &sr, &s,
                  &row, &row_count, &cl, &ct, &np, &rd};
  const int blocks =
      std::max(1, std::min((c + kThreads - 1) / kThreads, g_max_blocks));
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(rebuild_claim_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
