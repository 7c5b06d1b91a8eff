// K11 owner_pack: the packing stage of the partitioned sharded-map insert.
//
// Replaces ct_icp_tpu/parallel/sharded_map.py:152-166 (inside
// make_partitioned_update_fn's local_update): each point's voxel owner
// owner_hash(voxel_coords) % n, its rank among the valid points of the same
// owner in scan order (the reference's one-hot cumsum), and the scatter of
// the points whose rank is below the per-pair capacity into the send
// buffers send[owner, rank] (zeros elsewhere), with the count of the points
// dropped. The reference is no Pallas kernel; this is the one stage of the
// sharded insert that is not a collective or K3.
//
// One cooperative launch of resident blocks of 256 threads, block b owning
// the run of `tiles` 256-point tiles from b * tiles (the scan-order
// compaction of csrc/compact.cuh, generalised from one kept bit to n
// owners):
//   1. each thread derives its point's owner (-1 where invalid or past the
//      chunk) and keeps it in shared memory; the lanes of a warp with the
//      same owner find each other (__match_any_sync) and the lowest of them
//      writes their count to the block's cell [owner][tile][warp]; one
//      block scan (block_exclusive_scan) of the n * tiles * 8 cells gives
//      every cell its rank among the block's points of its owner, and each
//      owner's block total, which goes to block_cnt[owner][block] (scratch
//      kept by the caller);
//   2. one grid barrier; each warp sums block_cnt over the blocks before
//      this one and over all blocks for its owners (lanes over the blocks,
//      a shuffle reduction): the block's first rank and the total of each
//      owner; block 0 writes dropped = sum over owners of max(total - cap, 0);
//   3. each point goes to send[owner, rank] with rank = the block's first
//      rank + its cell's rank + the lanes below it with the same owner,
//      where rank < cap (three 4-byte stores: neighbouring lanes of one
//      owner write neighbouring rows); every block zero-fills its share of
//      each owner's rows [min(total, cap), cap) with 16-byte stores over
//      the flat [n, cap, 3] floats and [n, cap] flags, scalar at the
//      ragged ends.
// Counts are integers summed in a fixed order or order-free: no float or
// order-dependent atomic, so a call repeats bit for bit and equals the
// plain version exactly.
//
// A call's size is capped by the one launch: at most kMaxTiles tiles a
// block and n * tiles * kWarps <= kMaxCells cells, over the blocks
// resident together (k11_resident_blocks; tools/exp_owner.py prints it):
// m <= resident * min(16, 512 / n) * 256 points. kernels/owner_pack.py::
// layout raises a ValueError past it.
//
// Bound: bytes (the chunk's points and flags read once, the send buffers
// and the count written once). At the partitioned insert's shapes the
// time is latency: the launch, the barrier and the dependent prefix.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "compact.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOwners = 64;
constexpr int kMaxTiles = 16;              // tiles of kThreads points a block
constexpr int kMaxCells = 4096;            // n * tiles * kWarps of a block
constexpr int kMaxBlocks = 8192;

__device__ __forceinline__ uint32_t owner_hash(int cx, int cy, int cz) {
  return (static_cast<uint32_t>(cx) * 2654435761u ^
          static_cast<uint32_t>(cy) * 40503u) +
         static_cast<uint32_t>(cz) * 2246822519u;
}

// the owner of point i, -1 where it is invalid or past the chunk
__device__ __forceinline__ int owner_of(const float* __restrict__ world,
                                        const uint8_t* __restrict__ valid,
                                        int m, int i, float res, int n) {
  if (i >= m || !valid[i]) return -1;
  const int cx = cticp::voxel_coord(world[3 * i + 0], res);
  const int cy = cticp::voxel_coord(world[3 * i + 1], res);
  const int cz = cticp::voxel_coord(world[3 * i + 2], res);
  return static_cast<int>(owner_hash(cx, cy, cz) % static_cast<uint32_t>(n));
}

// Zero [a, e) of p's elements of type T by this grid thread's share
// (thread `tid` of `stride`): 16-byte stores where the address is aligned,
// single stores at the ragged ends.
template <typename T>
__device__ __forceinline__ void zero_range(T* p, long long a, long long e,
                                           long long tid, long long stride) {
  constexpr long long kPer = 16 / sizeof(T);
  if (a >= e) return;
  const auto addr = reinterpret_cast<uintptr_t>(p + a);
  long long a16 = a + static_cast<long long>(((16 - addr % 16) % 16) /
                                             sizeof(T));
  if (a16 > e) a16 = e;
  const long long e16 = a16 + (e - a16) / kPer * kPer;
  for (long long j = a + tid; j < a16; j += stride) p[j] = T(0);
  uint4* body = reinterpret_cast<uint4*>(p + a16);
  for (long long j = tid; j < (e16 - a16) / kPer; j += stride)
    body[j] = make_uint4(0u, 0u, 0u, 0u);
  for (long long j = e16 + tid; j < e; j += stride) p[j] = T(0);
}

// Every owner's rows [lim[o], cap) of send and send_valid, zero.
__device__ __forceinline__ void zero_fill(const int* lim, int n, int cap,
                                          float* send, uint8_t* send_valid,
                                          long long tid, long long stride) {
  for (int o = 0; o < n; ++o) {
    const long long r0 = static_cast<long long>(o) * cap + lim[o];
    const long long r1 = static_cast<long long>(o + 1) * cap;
    zero_range(send, 3 * r0, 3 * r1, tid, stride);
    zero_range(send_valid, r0, r1, tid, stride);
  }
}

__device__ __forceinline__ void write_row(const float* __restrict__ world,
                                          int i, int o, int r, int cap,
                                          float* send, uint8_t* send_valid) {
  const long long e = static_cast<long long>(o) * cap + r;
  send[3 * e + 0] = world[3 * i + 0];
  send[3 * e + 1] = world[3 * i + 1];
  send[3 * e + 2] = world[3 * i + 2];
  send_valid[e] = 1;
}

// Mutable arrays shared across blocks (block_cnt) carry no __restrict__
// and are read after the barrier through the L2 (__ldcg).
__global__ void __launch_bounds__(kThreads)
    owner_pack_kernel(const float* __restrict__ world,
                      const uint8_t* __restrict__ valid, int m, float res,
                      int n, int cap, int tiles, int32_t* block_cnt,
                      float* send, uint8_t* send_valid,
                      int32_t* __restrict__ dropped) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int8_t own[kMaxTiles * kThreads];
  __shared__ int cells[kMaxCells];
  __shared__ int tmp[kWarps + 1];
  __shared__ int first[kMaxOwners];        // the block's first rank
  __shared__ int lim[kMaxOwners];          // min(total, cap)
  __shared__ int over[kMaxOwners];         // max(total - cap, 0)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int tw = tiles * kWarps;
  const int b = blockIdx.x, nb = gridDim.x;
  const int tile0 = b * tiles;

  // ---- 1. owners, each (owner, tile, warp) cell's count, the block scan
  for (int c = threadIdx.x; c < n * tw; c += kThreads) cells[c] = 0;
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int i = (tile0 + t) * kThreads + threadIdx.x;
    const int o = owner_of(world, valid, m, i, res, n);
    own[t * kThreads + threadIdx.x] = static_cast<int8_t>(o);
    const unsigned same = __match_any_sync(0xffffffffu, o);
    if (o >= 0 && (same & below) == 0)
      cells[o * tw + t * kWarps + warp] = __popc(same);
  }
  __syncthreads();
  const int block_total = cticp::block_exclusive_scan<kThreads>(
      cells, n * tw, tmp);
  // owner o's first cell's rank among all the block's points
  auto start = [&](int o) {
    return o < n && tw > 0 ? cells[o * tw] : block_total;
  };
  for (int o = threadIdx.x; o < n; o += kThreads)
    block_cnt[o * nb + b] = start(o + 1) - start(o);
  grid.sync();

  // ---- 2. each owner's first rank in this block and its total
  for (int o = warp; o < n; o += kWarps) {
    int before = 0, total = 0;
    for (int q = lane; q < nb; q += 32) {
      const int c = __ldcg(block_cnt + o * nb + q);
      total += c;
      if (q < b) before += c;
    }
    for (int d = 16; d > 0; d >>= 1) {
      before += __shfl_xor_sync(0xffffffffu, before, d);
      total += __shfl_xor_sync(0xffffffffu, total, d);
    }
    if (lane == 0) {
      first[o] = before - start(o);
      lim[o] = min(total, cap);
      over[o] = max(total - cap, 0);
    }
  }
  __syncthreads();
  if (b == 0 && threadIdx.x == 0) {
    int d = 0;
    for (int o = 0; o < n; ++o) d += over[o];
    dropped[0] = d;
  }

  // ---- 3. the rows, then the zero fill past each owner's
  for (int t = 0; t < tiles; ++t) {
    const int o = own[t * kThreads + threadIdx.x];
    const unsigned same = __match_any_sync(0xffffffffu, o);
    if (o >= 0) {
      const int r = first[o] + cells[o * tw + t * kWarps + warp] +
                    __popc(same & below);
      if (r < cap)
        write_row(world, (tile0 + t) * kThreads + threadIdx.x, o, r, cap,
                  send, send_valid);
    }
  }
  zero_fill(lim, n, cap, send, send_valid,
            static_cast<long long>(b) * kThreads + threadIdx.x,
            static_cast<long long>(nb) * kThreads);
}

int g_max_blocks = 0;   // blocks resident together: the cooperative limit

int resident_blocks() {
  if (g_max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, owner_pack_kernel, kThreads, 0);
    if (e != cudaSuccess) return -static_cast<int>(e);
    g_max_blocks = std::min(per_sm * sms, kMaxBlocks);
  }
  return g_max_blocks;
}

}  // namespace

// The most owners (ranks) a call takes.
extern "C" int k11_max_owners() { return kMaxOwners; }

// The blocks of the kernel resident together on the current device (the
// most a cooperative launch takes), or minus the CUDA error.
extern "C" int k11_resident_blocks() { return resident_blocks(); }

// world f32 [m, 3], valid u8 [m]; `blocks` blocks of `tiles` 256-point
// tiles each, covering the chunk (kernels/owner_pack.py::layout picks
// them); block_cnt int32 [n * blocks], kept by the caller; send
// f32 [n, cap, 3], send_valid u8 [n, cap] and dropped int32 [1] written
// whole. One cooperative launch on `stream`; returns its error.
extern "C" int k11_owner_pack(const void* world, const void* valid, int m,
                              float res, int n, int cap, int tiles,
                              int blocks, void* block_cnt, void* send,
                              void* send_valid, void* dropped,
                              void* stream) {
  const int most = resident_blocks();
  if (most < 0) return -most;
  if (m < 0 || n < 1 || n > kMaxOwners || cap < 1 || tiles < 0 ||
      tiles > kMaxTiles || n * tiles * kWarps > kMaxCells || blocks < 1 ||
      blocks > most ||
      static_cast<long long>(blocks) * tiles * kThreads < m)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* w = static_cast<const float*>(world);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* s = static_cast<int32_t*>(block_cnt);
  auto* out = static_cast<float*>(send);
  auto* ov = static_cast<uint8_t*>(send_valid);
  auto* d = static_cast<int32_t*>(dropped);
  void* args[] = {&w, &v, &m, &res, &n, &cap, &tiles, &s, &out, &ov, &d};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(owner_pack_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
