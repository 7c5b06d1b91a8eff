// K11 owner_pack: the packing stage of the partitioned sharded-map insert.
//
// Replaces ct_icp_tpu/parallel/sharded_map.py:152-166 (inside
// make_partitioned_update_fn's local_update): each point's voxel owner
// owner_hash(voxel_coords) % n, its rank among the valid points of the same
// owner in scan order (the reference's one-hot cumsum), and the scatter of
// the points whose rank is below the per-pair capacity into the send
// buffers send[owner, rank] (zeros elsewhere). The reference is no Pallas
// kernel; this is the one stage of the sharded insert that is not a
// collective or K3.
//
// Two launches, a block of 256 threads over tiles of 1,024 points (four
// sub-tiles of 256, a thread a point in each):
//   1. count: each block counts its tile's valid points of each owner
//      (shared-memory counters; a count is order-free) into
//      counts[block, owner];
//   2. write: each block sums the counts of the blocks before it (its base
//      for each owner) and of all blocks (each owner's total), then walks
//      its four sub-tiles in order: a point's rank inside its warp is the
//      lanes below it with the same owner (__match_any_sync), inside the
//      block the same owner's points of the warps before it plus the
//      sub-tiles before it; the point goes to send[owner, base + rank] if
//      that is below cap. Every block also zero-fills its share of the
//      entries past each owner's min(total, cap), and block 0 writes the
//      dropped count, sum over owners of max(total - cap, 0): no float or
//      order-dependent atomics, so a call repeats bit for bit and equals
//      the plain version exactly.
//
// Bound: bytes (the chunk's points and flags read once, the send buffers
// written once). The two launches read the chunk twice (the owner is
// recomputed rather than stored) and the prefix reads every block's counts.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSub = 4;                    // sub-tiles a block
constexpr int kTile = kThreads * kSub;     // points a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOwners = 64;

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

__global__ void __launch_bounds__(kThreads)
    owner_count_kernel(const float* __restrict__ world,
                       const uint8_t* __restrict__ valid, int m, float res,
                       int n, int* __restrict__ counts) {
  __shared__ int cnt[kMaxOwners];
  for (int o = threadIdx.x; o < n; o += kThreads) cnt[o] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  for (int s = 0; s < kSub; ++s) {
    const int o = owner_of(world, valid, m, base + s * kThreads + threadIdx.x,
                           res, n);
    if (o >= 0) atomicAdd(cnt + o, 1);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < n; o += kThreads)
    counts[blockIdx.x * n + o] = cnt[o];
}

__global__ void __launch_bounds__(kThreads)
    owner_write_kernel(const float* __restrict__ world,
                       const uint8_t* __restrict__ valid, int m, float res,
                       int n, int cap, int nb,
                       const int* __restrict__ counts,
                       float* __restrict__ send,
                       uint8_t* __restrict__ send_valid,
                       int* __restrict__ dropped) {
  __shared__ int base_o[kMaxOwners];       // this block's first rank
  __shared__ int total_o[kMaxOwners];
  __shared__ int warp_cnt[kWarps][kMaxOwners];
  // nb: the count launch's blocks (0 for an empty chunk, where this
  // launch has one block that only zero-fills)
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int o = tid; o < n; o += kThreads) {
    int before = 0, all = 0;
    for (int q = 0; q < nb; ++q) {
      const int c = counts[q * n + o];
      if (q < b) before += c;
      all += c;
    }
    base_o[o] = before;
    total_o[o] = all;
  }
  __syncthreads();
  if (b == 0 && tid == 0) {
    int d = 0;
    for (int o = 0; o < n; ++o) d += max(total_o[o] - cap, 0);
    dropped[0] = d;
  }
  // the entries past each owner's points, zero: a grid-stride loop over
  // the n * cap entries, each written by exactly one thread of the grid
  const int stride = gridDim.x * kThreads;
  for (int e = b * kThreads + tid; e < n * cap; e += stride) {
    const int o = e / cap, q = e - o * cap;
    if (q >= min(total_o[o], cap)) {
      send[3 * e + 0] = 0.0f;
      send[3 * e + 1] = 0.0f;
      send[3 * e + 2] = 0.0f;
      send_valid[e] = 0;
    }
  }
  const unsigned below = (1u << lane) - 1u;
  for (int s = 0; s < kSub; ++s) {
    const int i = b * kTile + s * kThreads + tid;
    const int o = owner_of(world, valid, m, i, res, n);
    for (int v = tid; v < kWarps * n; v += kThreads)
      warp_cnt[v / n][v % n] = 0;
    __syncthreads();
    const unsigned same = __match_any_sync(0xffffffffu, o);
    if (o >= 0 && (same & below) == 0) warp_cnt[warp][o] = __popc(same);
    __syncthreads();
    if (o >= 0) {
      int r = base_o[o] + __popc(same & below);
      for (int w = 0; w < warp; ++w) r += warp_cnt[w][o];
      if (r < cap) {
        const int e = o * cap + r;
        send[3 * e + 0] = world[3 * i + 0];
        send[3 * e + 1] = world[3 * i + 1];
        send[3 * e + 2] = world[3 * i + 2];
        send_valid[e] = 1;
      }
    }
    __syncthreads();
    // the sub-tile's points of each owner move the next sub-tile's base
    for (int v = tid; v < n; v += kThreads) {
      int t = 0;
      for (int w = 0; w < kWarps; ++w) t += warp_cnt[w][v];
      base_o[v] += t;
    }
    __syncthreads();
  }
}

}  // namespace

// The most owners (ranks) a call takes.
extern "C" int k11_max_owners() { return kMaxOwners; }

// The blocks of a call over m points: the rows of the counts scratch.
extern "C" int k11_blocks(int m) {
  return m > 0 ? (m + kTile - 1) / kTile : 0;
}

// world f32 [m, 3], valid u8 [m]; counts int32 [k11_blocks(m), n] scratch;
// send f32 [n, cap, 3], send_valid u8 [n, cap] and dropped int32 [1]
// written whole. Two launches on `stream`; returns cudaGetLastError().
extern "C" int k11_owner_pack(const void* world, const void* valid, int m,
                              float res, int n, int cap, void* counts,
                              void* send, void* send_valid, void* dropped,
                              void* stream) {
  if (m < 0 || n < 1 || n > kMaxOwners || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* w = static_cast<const float*>(world);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* c = static_cast<int*>(counts);
  auto st = static_cast<cudaStream_t>(stream);
  const int nb = k11_blocks(m);
  // no point: the write launch still zero-fills and writes dropped = 0
  const int grid = nb > 0 ? nb : 1;
  if (nb > 0) {
    owner_count_kernel<<<nb, kThreads, 0, st>>>(w, v, m, res, n, c);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  owner_write_kernel<<<grid, kThreads, 0, st>>>(
      w, v, m, res, n, cap, nb, c, static_cast<float*>(send),
      static_cast<uint8_t*>(send_valid), static_cast<int*>(dropped));
  return static_cast<int>(cudaGetLastError());
}
