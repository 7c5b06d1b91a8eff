// The slot-claim rounds shared by K3 map_insert and K7 rebuild_claim: the
// device half of ct_icp_tpu/mapping/voxel_map.py::_resolve_or_claim_slots
// (:198-305), phase 2.
//
// Each unresolved claimant (flags == kValid) probes slot (hash + r) in round
// r = 0 .. MAX_PROBES - 1: a slot that holds its key resolves it; an EMPTY or
// TOMB slot takes its claim word by atomicMin; the winner of each claimed
// slot writes its key. At the start of round r a claimant re-reads round
// r - 1's slot, so a loser whose key the winner wrote resolves to that slot
// (and one more launch after the last round does that re-read alone).
//
// Arbitration is bit-exact with the reference's scatter-min: the claim word's
// low half is the claimant's ORIGINAL index, so the smallest index wins in
// whatever order the threads arrive. Never atomicCAS first-come: its winner
// depends on timing. The claim words are 64-bit: the high half is a stamp
// that decreases from round to round, so a round's claims always beat the
// leftovers of earlier rounds and the claim array is cleared (to all ones)
// only once per call.
#pragma once
#include "common.cuh"

namespace cticp {

// claimant flags
constexpr int kValid = 1, kResolved = 2;

// per-claimant rows, n entries each
struct ClaimRows {
  int32_t* slot;      // resolved slot, -1 before
  uint32_t* hash;     // probe hash
  uint32_t* key;      // identity key
  int32_t* flags;     // kValid | kResolved (callers may add higher bits)
  int32_t* attempt;   // the round of the last claim made, -1 none
};

__device__ __forceinline__ unsigned long long claim_word(int stamp, int pid) {
  return (static_cast<unsigned long long>(0xffffffffu - stamp) << 32) |
         static_cast<uint32_t>(pid);
}

// Claim round r, first half: the re-read of round r-1's slot, then round r's
// probe: an existing key resolves, an EMPTY/TOMB slot takes this claim.
__global__ void claim_attempt_kernel(const uint32_t* __restrict__ table,
                                     unsigned long long* __restrict__ claim,
                                     int n, uint32_t cap_mask, int r,
                                     int stamp, ClaimRows s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || s.flags[i] != kValid) return;  // invalid or resolved
  const uint32_t h = s.hash[i], key = s.key[i];
  if (r > 0) {
    const uint32_t prev = (h + static_cast<uint32_t>(r - 1)) & cap_mask;
    if (table[prev] == key) {
      s.slot[i] = static_cast<int>(prev);
      s.flags[i] |= kResolved;
      return;
    }
  }
  if (r >= kMaxProbes) return;
  const uint32_t at = (h + static_cast<uint32_t>(r)) & cap_mask;
  const uint32_t k = table[at];
  if (k == key) {
    s.slot[i] = static_cast<int>(at);
    s.flags[i] |= kResolved;
    return;
  }
  if (k == kEmpty || k == kTomb) {
    atomicMin(claim + at, claim_word(stamp, i));
    s.attempt[i] = r;
  }
}

// Claim round r, second half: the winner of each claimed slot writes its key.
__global__ void claim_write_kernel(uint32_t* __restrict__ table,
                                   const unsigned long long* __restrict__ claim,
                                   int n, uint32_t cap_mask, int r, int stamp,
                                   ClaimRows s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || s.flags[i] != kValid || s.attempt[i] != r) return;
  const uint32_t at = (s.hash[i] + static_cast<uint32_t>(r)) & cap_mask;
  if (claim[at] == claim_word(stamp, i)) table[at] = s.key[i];
}

// Launch all MAX_PROBES rounds and the final re-read on stream ``st`` with
// stamps ``stamp`` .. ``stamp + MAX_PROBES``; ``claim`` must hold no word
// with a smaller stamp than these (all ones after a clear). Returns the next
// unused stamp.
inline int launch_claim_rounds(uint32_t* table, unsigned long long* claim,
                               int n, uint32_t cap_mask, int stamp,
                               ClaimRows s, int blocks, int threads,
                               cudaStream_t st) {
  for (int r = 0; r < kMaxProbes; ++r, ++stamp) {
    claim_attempt_kernel<<<blocks, threads, 0, st>>>(table, claim, n,
                                                     cap_mask, r, stamp, s);
    claim_write_kernel<<<blocks, threads, 0, st>>>(table, claim, n, cap_mask,
                                                   r, stamp, s);
  }
  // the re-read of the last round's slot
  claim_attempt_kernel<<<blocks, threads, 0, st>>>(table, claim, n, cap_mask,
                                                   kMaxProbes, stamp, s);
  return stamp;
}

}  // namespace cticp
