// K7 rebuild_claim: the hash-table half of the floating-origin map rebase.
//
// Replaces the table rebuild of ct_icp_tpu/mapping/voxel_map.py::
// rebuild_level (:619-640): for every row with keys > TOMB and count > 0,
// subtract the shift from the row's first point (x, y, z at columns 0, P and
// 2P, _first_point :133), re-derive its voxel (truncf(x / v), built with
// -fmad=false as K3), its 3-prime probe hash and identity key, claim a slot
// for it in a fresh table with the insert's claim rounds (claim.cuh, shared
// with K3: MAX_PROBES = 16 rounds, atomicMin of the ROW index, losers
// re-read, so rows with equal keys resolve to one slot), then elect each
// slot's writer: src[slot] = the largest row index resolved to it (the
// reference's scatter-max of the row index), -1 where no row landed. K6
// row_gather then moves the rows: out[s] = rows[src[s]] - shift.
//
// Rows that merge near the origin (two voxels' first points truncating to
// one voxel id after the shift) resolve to one slot and only the writer's
// row survives; rows still unresolved after 16 rounds are dropped, as the
// reference drops them.
//
// One thread per row: a derive launch, 2 x 16 claim launches and a re-read,
// the election; the fresh table is a cudaMemsetAsync to 0 (EMPTY) and src a
// memset to -1. Bound: bytes, every key read and every table and src slot
// written (12 B a slot), the count of each row with a live key (4 B) and
// the first point of each occupied row (12 B); the rounds are
// launch-bound, and most threads return at once after round 0 or 1.
#include "claim.cuh"

namespace {

using cticp::kResolved;
using cticp::kValid;

__global__ void derive_kernel(const uint32_t* __restrict__ keys,
                              const int32_t* __restrict__ count,
                              const float* __restrict__ points,
                              const float* __restrict__ shift, int c, int p,
                              float resolution, cticp::ClaimRows s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const uint32_t k = keys[i];
  const bool occupied = k != cticp::kEmpty && k != cticp::kTomb &&
                        count[i] > 0;
  s.slot[i] = -1;
  s.attempt[i] = -1;
  s.flags[i] = occupied ? kValid : 0;
  if (!occupied) return;
  const float* row = points + static_cast<size_t>(i) * 3 * p;
  const int cx = cticp::voxel_coord(row[0] - shift[0], resolution);
  const int cy = cticp::voxel_coord(row[p] - shift[1], resolution);
  const int cz = cticp::voxel_coord(row[2 * p] - shift[2], resolution);
  s.hash[i] = cticp::voxel_hash_u32(cx, cy, cz);
  s.key[i] = cticp::voxel_key_u32(cx, cy, cz);
}

__global__ void elect_writer_kernel(int32_t* __restrict__ src, int c,
                                    cticp::ClaimRows s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c || !(s.flags[i] & kResolved)) return;
  atomicMax(src + s.slot[i], i);
}

__global__ void claim_attempt_kernel(const uint32_t* __restrict__ table,
                                     unsigned long long* __restrict__ claim,
                                     int n, uint32_t cap_mask, int r,
                                     int stamp, cticp::ClaimRows s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || s.flags[i] != kValid) return;  // invalid or resolved
  cticp::claim_attempt(table, claim, i, cap_mask, r, stamp, s);
}

__global__ void claim_write_kernel(uint32_t* __restrict__ table,
                                   const unsigned long long* __restrict__ claim,
                                   int n, uint32_t cap_mask, int r, int stamp,
                                   cticp::ClaimRows s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  cticp::claim_write(table, claim, i, cap_mask, r, stamp, s);
}

// Launch all MAX_PROBES rounds and the final re-read on stream ``st`` with
// stamps ``stamp`` .. ``stamp + MAX_PROBES``; ``claim`` must hold no word
// with a smaller stamp than these (all ones after a clear). Returns the next
// unused stamp.
int launch_claim_rounds(uint32_t* table, unsigned long long* claim, int n,
                        uint32_t cap_mask, int stamp, cticp::ClaimRows s,
                        int blocks, int threads, cudaStream_t st) {
  for (int r = 0; r < cticp::kMaxProbes; ++r, ++stamp) {
    claim_attempt_kernel<<<blocks, threads, 0, st>>>(table, claim, n,
                                                     cap_mask, r, stamp, s);
    claim_write_kernel<<<blocks, threads, 0, st>>>(table, claim, n, cap_mask,
                                                   r, stamp, s);
  }
  // the re-read of the last round's slot
  claim_attempt_kernel<<<blocks, threads, 0, st>>>(
      table, claim, n, cap_mask, cticp::kMaxProbes, stamp, s);
  return stamp;
}

}  // namespace

// keys (uint32 bits), count: int32 [c]; points: f32 [c, 3p]; shift: f32 [3]
// on the device. Writes table: uint32 [c] (the fresh keys) and src: int32
// [c]. scratch: int32 [5 * c]; claim: uint64 [c].
extern "C" int k7_rebuild_claim(const void* keys, const void* count,
                                const void* points, const void* shift,
                                int c, int p, float resolution, void* table,
                                void* src, void* scratch, void* claim,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(table, 0, sizeof(uint32_t) * c, st);
  cudaMemsetAsync(src, 0xff, sizeof(int32_t) * c, st);
  if (c > 0) {
    int32_t* sc = static_cast<int32_t*>(scratch);
    cticp::ClaimRows s{sc, reinterpret_cast<uint32_t*>(sc + c),
                       reinterpret_cast<uint32_t*>(sc + 2 * c), sc + 3 * c,
                       sc + 4 * c};
    auto* tb = static_cast<uint32_t*>(table);
    auto* cl = static_cast<unsigned long long*>(claim);
    const int threads = 256;
    const int blocks = (c + threads - 1) / threads;
    cudaMemsetAsync(claim, 0xff, sizeof(unsigned long long) * c, st);
    derive_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(count),
        static_cast<const float*>(points), static_cast<const float*>(shift), c,
        p, resolution, s);
    launch_claim_rounds(tb, cl, c, static_cast<uint32_t>(c - 1), 0, s, blocks,
                        threads, st);
    elect_writer_kernel<<<blocks, threads, 0, st>>>(static_cast<int32_t*>(src),
                                                    c, s);
  }
  return static_cast<int>(cudaGetLastError());
}
