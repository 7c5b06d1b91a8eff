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
// low half is the claimant's ORIGINAL index (`pid`, which need not be the
// entry `e` of its claimant rows), so the smallest index wins in whatever
// order the threads arrive. Never atomicCAS first-come: its winner
// depends on timing. The claim words are 64-bit: the high half is a stamp
// that decreases from round to round, so a round's claims always beat the
// leftovers of earlier rounds and the claim array is cleared (to all ones)
// only once per call (K7), or only when the stamps wrap (K3, whose claim
// words and stamp persist from call to call).
//
// K3 and K7 call the halves from their one cooperative kernel, between grid
// barriers; K3's claimant rows are indexed by the point index (e == pid),
// K7's by the claimant's place in its compact list (pid: its row).
#pragma once
#include "common.cuh"

namespace cticp {

// claimant flags
constexpr int kValid = 1, kResolved = 2;

// per-claimant rows, one entry a claimant
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

// Claim round r, first half, for claimant entry e (flags == kValid) of
// original index pid: the re-read of round r-1's slot, then round r's probe:
// an existing key resolves, an EMPTY/TOMB slot takes this claim. Returns
// false where the re-read resolved it, true where it went on to round r's
// probe (r < MAX_PROBES).
__device__ __forceinline__ bool claim_attempt(const uint32_t* table,
                                              unsigned long long* claim,
                                              int e, int pid,
                                              uint32_t cap_mask, int r,
                                              int stamp, const ClaimRows& s) {
  const uint32_t h = s.hash[e], key = s.key[e];
  if (r > 0) {
    const uint32_t prev = (h + static_cast<uint32_t>(r - 1)) & cap_mask;
    if (table[prev] == key) {
      s.slot[e] = static_cast<int>(prev);
      s.flags[e] |= kResolved;
      return false;
    }
  }
  if (r >= kMaxProbes) return false;
  const uint32_t at = (h + static_cast<uint32_t>(r)) & cap_mask;
  const uint32_t k = table[at];
  if (k == key) {
    s.slot[e] = static_cast<int>(at);
    s.flags[e] |= kResolved;
  } else if (k == kEmpty || k == kTomb) {
    atomicMin(claim + at, claim_word(stamp, pid));
    s.attempt[e] = r;
  }
  return true;
}

// Claim round r, second half: the winner of each claimed slot writes its key.
__device__ __forceinline__ void claim_write(uint32_t* table,
                                           const unsigned long long* claim,
                                           int e, int pid, uint32_t cap_mask,
                                           int r, int stamp,
                                           const ClaimRows& s) {
  if (s.flags[e] != kValid || s.attempt[e] != r) return;
  const uint32_t at = (s.hash[e] + static_cast<uint32_t>(r)) & cap_mask;
  if (claim[at] == claim_word(stamp, pid)) table[at] = s.key[e];
}

}  // namespace cticp
