// K10 level_normals: the map export's normal refit of the listed voxels.
//
// Replaces ct_icp_tpu/mapping/voxel_map.py::_voxel_plane_fit (:524-546) and
// ::recompute_level_normals (:549-561): of the listed slots, every slot
// whose key is a voxel's (not EMPTY or TOMB) and which holds at least 5
// points gets a plane fit from the moments of its points about its first
// point (description_from_moments, the eigensolve of csrc/eigh3.cuh shared
// with K2), its normal flipped where (barycenter - location) . normal > 0,
// and its flag set to 2; every other listed slot keeps its normal and flag.
// The results go into NEW tensors, a row for each listed slot: the
// reference refits a copy of the level for the export
// (odometry.py:1268-1274) and leaves the map's own normals alone, and so
// does the port. The export lists the occupied slots it copies out
// (Odometry.get_map_points), so the slots it does not export are not read.
//
// One launch over the S listed slots, blocks of 256 threads, three passes a
// block:
//   1. a thread a listed slot (256 a block, or fewer where the list is
//      short, below): it reads the slot's index (coalesced), key and
//      count, and copies the normal and flag of a slot that is not refit
//      through; a refit slot goes into the block's queue in shared
//      memory (a warp ballot, its popcount and a prefix over the block's
//      eight warps), and the thread that found it does not fit it;
//   2. a group of G lanes a queued slot: the group reads the slot's
//      planar x / y / z rows coalesced (lane j takes points j, j + G, ...),
//      sums the nine moments about point 0 by shuffles and parks them,
//      with the origin, in shared memory;
//   3. after a barrier, a thread a queued slot: the eigensolve and the
//      orientation, and the output row.
// The listed slots a block: the smallest power of two from 8 that spreads
// the list over at most 4 blocks an SM (256 beyond). A lane a listed slot
// in pass 1 keeps level 0 of an export (31,589 listed slots, 191 refit:
// 494 blocks of 64) to one wave with 32 gathers in flight a warp; the
// queue gives a refit-heavy list (the dirty-slot refit lists only refit
// slots) every lane of a group for the point rows and every thread for
// the eigensolves, where one warp a listed slot left 31 lanes idle in
// each; a short list takes fewer slots a block, so that its refits spread
// over the card's SMs (the first version, blocks of 256 slots for level 0
// and of 32 for level 2's 936 listed slots, ran level 2's 858 refits four
// deep a warp on 30 SMs: 6.7 us against a warp a listed slot's 4.0).
// The lanes a queued slot, G, follow the grid: a grid of at most one block
// an SM (level 2 of an export: 117 blocks of 8 slots) has few warps on
// each SM, and a warp a queued slot (G = 32) spreads a slot's points
// widest; a grid of more (level 1, the all-refit list: 362 and 373
// blocks) shares each SM between blocks, and G = 8 (three shuffle levels
// where a warp takes five, a lane 4-5 of a slot's points) finishes the
// moments sooner (each G forced, on an H100 80GB HBM3; PERF.md section 6:
// level 1 4.67 against 5.49 us, the all-refit list 4.42 against 4.90,
// level 2 5.41 against 4.90).
//
// Bound: bytes. Each listed slot's index, key and count read and its
// normal and flag written (28 B), the normal and flag of each listed slot
// not refit read (16 B), and the live points of each refit slot read (12 B
// a point); a few hundred operations a refit slot. Float sums are taken in
// another order than the plain version's, so normals differ in the last
// bits; the set of refit slots and the flags come from integer compares
// and are exact.
#include "common.cuh"
#include "eigh3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kMinPoints = 5;
constexpr int kRefitFlag = 2;
// a queued slot's nine moments about its first point (x, y, z, xx, xy, xz,
// yy, yz, zz), then that point
constexpr int kParked = 12;

template <int kGroup>
__global__ void __launch_bounds__(kThreads) level_normals_kernel(
    const uint32_t* __restrict__ keys, const int32_t* __restrict__ count,
    const float* __restrict__ points, const float* __restrict__ normals,
    const int32_t* __restrict__ nflags, const float* __restrict__ location,
    const int32_t* __restrict__ slots, int n_slots, int per_block, int p,
    float* __restrict__ out_normals, int32_t* __restrict__ out_nflags) {
  __shared__ int q_item[kThreads];
  __shared__ int q_slot[kThreads];
  __shared__ int q_n[kThreads];
  __shared__ float q_m[kParked][kThreads];
  __shared__ int warp_base[kWarps + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // pass 1: classify, copy through, queue
  const int i = blockIdx.x * per_block + tid;
  bool refit = false;
  int slot = 0;
  int cnt = 0;
  if (tid < per_block && i < n_slots) {
    slot = slots[i];
    const uint32_t key = keys[slot];
    cnt = count[slot];
    refit = key > cticp::kTomb && cnt >= kMinPoints;
    if (!refit) {
      out_normals[3 * i + 0] = normals[3 * slot + 0];
      out_normals[3 * i + 1] = normals[3 * slot + 1];
      out_normals[3 * i + 2] = normals[3 * slot + 2];
      out_nflags[i] = nflags[slot];
    }
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, refit);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_base[w];
      warp_base[w] = run;
      run += c;
    }
    warp_base[kWarps] = run;
  }
  __syncthreads();
  const int queued = warp_base[kWarps];
  if (queued == 0) return;  // the whole block
  if (refit) {
    const int at = warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
    q_item[at] = i;
    q_slot[at] = slot;
    q_n[at] = min(cnt, p);
  }
  __syncthreads();

  // pass 2: a group of kGroup lanes a queued slot sums its moments
  constexpr int kGroups = kThreads / kGroup;
  const int group = tid / kGroup;
  const int member = tid % kGroup;
  const unsigned mask = (0xffffffffu >> (32 - kGroup))
                        << (lane & ~(kGroup - 1));
  for (int q = group; q < queued; q += kGroups) {
    const int n = q_n[q];
    const float* row = points + static_cast<size_t>(q_slot[q]) * (3 * p);
    const float ox = row[0], oy = row[p], oz = row[2 * p];
    float m[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) m[k] = 0.0f;
    for (int j = member; j < n; j += kGroup) {
      const float rx = row[j] - ox;
      const float ry = row[p + j] - oy;
      const float rz = row[2 * p + j] - oz;
      m[0] += rx;
      m[1] += ry;
      m[2] += rz;
      m[3] += rx * rx;
      m[4] += rx * ry;
      m[5] += rx * rz;
      m[6] += ry * ry;
      m[7] += ry * rz;
      m[8] += rz * rz;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int sh = kGroup / 2; sh > 0; sh >>= 1)
        m[k] += __shfl_xor_sync(mask, m[k], sh);
    if (member == 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) q_m[k][q] = m[k];
      q_m[9][q] = ox;
      q_m[10][q] = oy;
      q_m[11][q] = oz;
    }
  }
  __syncthreads();

  // pass 3: a thread a queued slot: description_from_moments, then the
  // orientation toward location
  if (tid >= queued) return;
  const float cs = fmaxf(static_cast<float>(q_n[tid]), 1.0f);
  float m[kParked];
#pragma unroll
  for (int k = 0; k < kParked; ++k) m[k] = q_m[k][tid];
  const float mean[3] = {m[0] / cs, m[1] / cs, m[2] / cs};
  const float so[3][3] = {{m[3], m[4], m[5]},
                          {m[4], m[6], m[7]},
                          {m[5], m[7], m[8]}};
  float cov[3][3];
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) cov[a][c] = so[a][c] / cs - mean[a] * mean[c];
  const cticp::Eig eig = cticp::eigh3x3_normal(cov);
  const float dot = ((mean[0] + m[9] - location[0]) * eig.normal[0] +
                     (mean[1] + m[10] - location[1]) * eig.normal[1]) +
                    (mean[2] + m[11] - location[2]) * eig.normal[2];
  const float sign = dot > 0.0f ? -1.0f : 1.0f;
  const int out = q_item[tid];
  out_normals[3 * out + 0] = sign * eig.normal[0];
  out_normals[3 * out + 1] = sign * eig.normal[1];
  out_normals[3 * out + 2] = sign * eig.normal[2];
  out_nflags[out] = kRefitFlag;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 1;
  }
  return sms;
}

// Listed slots a block: the smallest power of two from 8 to kThreads with
// which the list takes at most kBlocksPerSm blocks an SM (kThreads beyond).
int per_block(int n_slots) {
  int per = 8;
  while (per < kThreads &&
         static_cast<long long>(per) * kBlocksPerSm * sm_count() < n_slots)
    per *= 2;
  return per;
}

int blocks_of(int n_slots) {
  const int per = per_block(n_slots);
  return (n_slots + per - 1) / per;
}

}  // namespace

// The lanes a queued slot's moments take in a call over n_slots listed
// slots: a warp where the grid has at most one block an SM, else 8.
extern "C" int k10_lanes(int n_slots) {
  return blocks_of(n_slots) <= sm_count() ? 32 : 8;
}

// keys / count / nflags int32[C], points f32[C, 3P] (planar rows),
// normals f32[C, 3], location f32[3], slots int32[S] (each in [0, C));
// out_normals f32[S, 3] and out_nflags int32[S] are written in full.
extern "C" int k10_level_normals(const void* keys, const void* count,
                                 const void* points, const void* normals,
                                 const void* nflags, const void* location,
                                 const void* slots, int n_slots, int p,
                                 void* out_normals, void* out_nflags,
                                 void* stream) {
  if (n_slots > 0) {
    auto kernel = k10_lanes(n_slots) == 32 ? level_normals_kernel<32>
                                           : level_normals_kernel<8>;
    kernel<<<blocks_of(n_slots), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(count),
        static_cast<const float*>(points), static_cast<const float*>(normals),
        static_cast<const int32_t*>(nflags),
        static_cast<const float*>(location),
        static_cast<const int32_t*>(slots), n_slots, per_block(n_slots), p,
        static_cast<float*>(out_normals), static_cast<int32_t*>(out_nflags));
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid a call of n_slots listed slots launches (the
// floor of a launch, tools/exp_normals.py).
__global__ void __launch_bounds__(kThreads) level_normals_empty() {}

extern "C" int k10_empty(int n_slots, void* stream) {
  if (n_slots > 0)
    level_normals_empty<<<blocks_of(n_slots), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
