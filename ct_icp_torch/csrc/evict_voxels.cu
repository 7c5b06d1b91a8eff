// K9 evict_voxels: empty the listed voxels of a map level, in place.
//
// Replaces ct_icp_tpu/mapping/voxel_map.py::evict_voxels (:564-593), the
// backend replay's eviction (odometry.py::replay_refined_frames): each
// valid coordinate is looked up (K1's probe, csrc/probe.cuh); where the
// voxel is present its count and normal flag drop to 0 and its key stays,
// so probe chains stay intact and a later insert of the voxel refills the
// same slot. num_points drops by the points removed, which the call also
// returns. The reference's probe window (``win``) is TPU layout and the
// port has none, so nothing is rebuilt.
//
// One launch, a thread per coordinate: the count is taken by atomicExch, so
// a slot listed twice is emptied once and counted once; each block sums
// what its threads removed (warp shuffles, then one integer atomicAdd into
// a per-device accumulator); the last block to finish (an integer ticket
// after a fence) subtracts the total from num_points, writes it to the
// output and resets the accumulator and the ticket, so no call clears
// anything and the host reads nothing.
//
// Bound: bytes. Every valid flag read (1 B a coordinate); for each valid
// coordinate its 12 B and the probed 16 B key window (a padding row's
// coordinates are not read); for each found slot its count read and its
// count and flag written; no arithmetic to speak of (two hashes and a
// compare chain a coordinate).
#include "common.cuh"
#include "probe.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) evict_voxels_kernel(
    const uint32_t* __restrict__ keys, int32_t* __restrict__ count,
    int32_t* __restrict__ nflags, int32_t* __restrict__ num_points,
    const int32_t* __restrict__ coords, const uint8_t* __restrict__ valid,
    int m, uint32_t cap_mask, int32_t* __restrict__ scratch,
    int32_t* __restrict__ removed) {
  __shared__ int32_t warp_sums[kThreads / 32];
  __shared__ bool last;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int32_t took = 0;
  if (i < m && valid[i]) {
    const int slot = cticp::probe_slot(keys, cap_mask, coords[3 * i + 0],
                                       coords[3 * i + 1], coords[3 * i + 2]);
    if (slot >= 0) {
      took = atomicExch(count + slot, 0);
      nflags[slot] = 0;
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
    if (block != 0) atomicAdd(scratch, block);
    __threadfence();
    last = atomicAdd(scratch + 1, 1) == static_cast<int32_t>(gridDim.x) - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    const int32_t total = atomicExch(scratch, 0);
    scratch[1] = 0;
    removed[0] = total;
    num_points[0] -= total;
  }
}

}  // namespace

// keys / count / nflags int32[C] (C a power of two >= 8, keys 16-byte
// aligned), num_points int32[1], coords int32[M, 3], valid uint8[M];
// scratch int32[2] (accumulator, ticket), zero before the first call and
// left zero by every call; removed int32[1] out.
extern "C" int k9_evict_voxels(void* keys, void* count, void* nflags,
                               void* num_points, const void* coords,
                               const void* valid, int m, int cap,
                               void* scratch, void* removed, void* stream) {
  const int blocks = m > 0 ? (m + kThreads - 1) / kThreads : 1;
  evict_voxels_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(count),
      static_cast<int32_t*>(nflags), static_cast<int32_t*>(num_points),
      static_cast<const int32_t*>(coords), static_cast<const uint8_t*>(valid),
      m, static_cast<uint32_t>(cap - 1), static_cast<int32_t*>(scratch),
      static_cast<int32_t*>(removed));
  return static_cast<int>(cudaGetLastError());
}
