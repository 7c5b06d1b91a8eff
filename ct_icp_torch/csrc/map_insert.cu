// K3 map_insert: insert a point batch into one voxel-map level, in place.
//
// Replaces the body of ct_icp_tpu/mapping/voxel_map.py::insert_points with
// with_normals=False (:366-522): _resolve_or_claim_slots (:198-305), the
// min-distance check, _elect_ranks (:327-363), the planar scatter at
// count + rank, the count add and num_points. Its claim phase is the Hopper
// counterpart of the first-wins claim table of the Pallas kernel
// tools/pallas_kernels_experiment.py:35 (dedup_compact).
//
// One cooperative launch: only as many blocks as are resident together, the
// points walked in grid-stride loops, and a grid barrier
// (cooperative_groups::this_grid().sync()) between phases:
//   1. resolve: voxel, hashes, the probe-window lookup; the unresolved
//      claimants are appended to a compact list (warp-aggregated) and make
//      claim round 0's probe;
//   2. the claim rounds of claim.cuh over that list (MAX_PROBES = 16), two
//      barriers a round: round r's winners write their keys | round r + 1's
//      re-read and probe;
//   3. min-distance and eligibility; the eligible points appended to a list
//      and election round 0's claims made;
//   4. the election rounds over that list (max_rounds), one barrier a
//      round: a phase checks round r - 1's winners, scatters them at
//      count + rank at once (count add, num_points), and makes round r's
//      claims into the other half of the claim words (two halves of C,
//      used by round parity, so no claim of round r touches a word round
//      r - 1's check reads).
// With a `rank0` list (the with_normals insert's dirty voxels), each point
// also reports the slot it was accepted into with election rank 0, -1 for
// every other point (phase 1 writes the -1, phase 4 the slot).
// The reference's two early exits are back: the claim rounds stop once every
// claimant is resolved ("nearly every batch resolves within the first 1-3
// probe rounds", voxel_map.py:276-284), the election once no eligible point
// is left unplaced (:347-361). Each round counts its live entries into its
// own device counter, every block reads it after the barrier, so every
// block takes the same decision. They change the work done, nothing else.
//
// Arbitration is bit-exact with the reference: the stamped 64-bit claim
// words of claim.cuh, an atomicMin of the ORIGINAL scan index over the
// EMPTY/TOMB slots its claimants probe; an election round is an atomicMin
// of the point index over each slot. The reference elects on the compacted
// eligible index, whose order equals the scan order, so the winners are the
// same. The claim words and the stamp persist from call to call (the
// control block, below), so no call clears the C claim words: every round
// takes a new, larger stamp, and the words are cleared only when the stamp
// would wrap.
//
// Bound: the min-distance check, which reads the existing rows of every
// point's voxel (N x 3P floats, gathered); claim and election rounds touch
// a few words per live entry. The grid barriers set the time: 1 + 2 per
// claim round + 1 per election round.
#include <cooperative_groups.h>

#include <algorithm>

#include "claim.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRounds = 64;            // election rounds a call may ask
// control block (int32 [kCtrlInts], zeros before the first call): the next
// stamp, the counter set this call uses, then two sets of counters; a call
// uses one and zeroes the other for the next call
constexpr int kCtrlStamp = 0, kCtrlSet = 1, kCtrlCounters = 32;
constexpr int kNClaim = 0, kNElig = 1, kLive = 2,
              kRemain = kLive + cticp::kMaxProbes + 1,
              kSetInts = kRemain + kMaxRounds + 1;
constexpr int kCtrlInts = kCtrlCounters + 2 * kSetInts;
constexpr int kStampLimit = 1 << 30;
static_assert(kSetInts <= kThreads, "one block zeroes a counter set");

// scratch rows (int32 [kScratchRows, n])
enum : int {
  kSlot = 0, kHash, kKey, kFlags, kEcount, kRank, kAttempt, kList, kScratchRows
};
using cticp::claim_word;
using cticp::kResolved;
using cticp::kValid;
constexpr int kEligible = 4;

struct Scratch {
  int32_t* slot;
  uint32_t* hash;
  uint32_t* key;
  int32_t* flags;
  int32_t* ecount;
  int32_t* rank;
  int32_t* attempt;
  int32_t* list;      // the claimants, then the eligible points
};

// Append, warp by warp, the lanes with `pred` to the list counted by
// `counter`; every lane of the warp calls it. Returns the lane's index.
__device__ __forceinline__ int warp_append(int32_t* counter, bool pred) {
  const unsigned want = __ballot_sync(0xffffffffu, pred);
  if (!want) return -1;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(want) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(want));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(want & ((1u << lane) - 1u));
}

__device__ __forceinline__ void warp_count(int32_t* counter, bool pred) {
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  if ((threadIdx.x & 31) == 0 && m) atomicAdd(counter, __popc(m));
}

// Mutable arrays carry no __restrict__/const: a block reads what another
// block wrote before the last grid barrier, never through the read-only
// cache.
__global__ void __launch_bounds__(kThreads)
    map_insert_kernel(uint32_t* table, int32_t* count, float* points,
                      int32_t* num_points, const float* __restrict__ pts,
                      const uint8_t* __restrict__ valid, int n, int cap,
                      int p, float resolution, float min_d2, int max_rounds,
                      Scratch s, unsigned long long* claim, int32_t* ctrl,
                      int32_t* inserted, int32_t* rank0) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads;     // a block's first item
  const int tid = first + threadIdx.x;
  const uint32_t cap_mask = static_cast<uint32_t>(cap - 1);
  const cticp::ClaimRows rows{s.slot, s.hash, s.key, s.flags, s.attempt};

  int stamp = ctrl[kCtrlStamp];
  const int set = ctrl[kCtrlSet];
  int32_t* cnt = ctrl + kCtrlCounters + set * kSetInts;
  if (stamp > kStampLimit) {                   // every block agrees
    for (int i = tid; i < 2 * cap; i += stride) claim[i] = ~0ull;
    stamp = 0;
    grid.sync();
  }
  if (blockIdx.x == 0) {
    ctrl[kCtrlCounters + (1 - set) * kSetInts + threadIdx.x % kSetInts] = 0;
    if (threadIdx.x == 0) *inserted = 0;
  }

  // ---- 1. resolve: the probe-window lookup of the existing voxel
  for (int i0 = first; i0 < n; i0 += stride) {
    const int i = i0 + threadIdx.x;
    bool claimant = false;
    if (i < n) {
      const int cx = cticp::voxel_coord(pts[3 * i + 0], resolution);
      const int cy = cticp::voxel_coord(pts[3 * i + 1], resolution);
      const int cz = cticp::voxel_coord(pts[3 * i + 2], resolution);
      const uint32_t h = cticp::voxel_hash_u32(cx, cy, cz);
      const uint32_t key = cticp::voxel_key_u32(cx, cy, cz);
      s.hash[i] = h;
      s.key[i] = key;
      s.attempt[i] = -1;
      s.rank[i] = -1;
      if (rank0) rank0[i] = -1;
      int flags = valid[i] ? kValid : 0;
      int slot = -1;
      if (flags) {
        for (int j = 0; j < cticp::kProbeWindow; ++j) {
          const uint32_t at = (h + j) & cap_mask;
          const uint32_t k = table[at];
          if (k == cticp::kEmpty) break;
          if (k == key) {
            slot = static_cast<int>(at);
            flags |= kResolved;
            break;
          }
        }
      }
      s.slot[i] = slot;
      s.flags[i] = flags;
      claimant = flags == kValid;
      // claim round 0's probe (round 0 has no re-read)
      if (claimant)
        cticp::claim_attempt(table, claim, i, i, cap_mask, 0, stamp, rows);
    }
    const int at = warp_append(cnt + kNClaim, claimant);
    if (claimant) s.list[at] = i;
  }
  grid.sync();

  // ---- 2. claim rounds over the claimants; stop once all are resolved.
  // Round r's winners write their keys, then round r + 1's re-read and
  // probe, counting the claimants still live.
  const int n_claim = cnt[kNClaim];
  int live = n_claim;
  for (int r = 0; live > 0 && r < cticp::kMaxProbes; ++r) {
    for (int e = tid; e < n_claim; e += stride) {
      const int i = s.list[e];
      cticp::claim_write(table, claim, i, i, cap_mask, r, stamp + r, rows);
    }
    grid.sync();
    for (int e0 = first; e0 < n_claim; e0 += stride) {
      const int e = e0 + threadIdx.x;
      bool still = false;
      if (e < n_claim) {
        const int i = s.list[e];
        if (s.flags[i] == kValid)
          still = cticp::claim_attempt(table, claim, i, i, cap_mask, r + 1,
                                       stamp + r + 1, rows);
      }
      warp_count(cnt + kLive + r + 1, still);
    }
    grid.sync();
    live = cnt[kLive + r + 1];
  }
  stamp += cticp::kMaxProbes;

  // ---- 3. min-distance check against the voxel's points; eligibility;
  // election round 0's claim
  for (int i0 = first; i0 < n; i0 += stride) {
    const int i = i0 + threadIdx.x;
    bool eligible = false;
    if (i < n) {
      const int flags = s.flags[i];
      const bool resolved = flags & kResolved;
      const int slot = resolved ? s.slot[i] : 0;
      const int ec = count[slot];
      const float* row = points + static_cast<size_t>(slot) * 3 * p;
      const float px = pts[3 * i + 0], py = pts[3 * i + 1],
                  pz = pts[3 * i + 2];
      float best = __int_as_float(0x7f800000);
      for (int j = 0; j < ec && j < p; ++j) {
        const float dx = row[j] - px, dy = row[p + j] - py,
                    dz = row[2 * p + j] - pz;
        best = fminf(best, dx * dx + dy * dy + dz * dz);
      }
      const bool far_enough = ec == 0 || best > min_d2;
      s.ecount[i] = ec;
      s.slot[i] = slot;
      eligible = resolved && far_enough && ec < p;
      if (eligible) {
        s.flags[i] = flags | kEligible;
        if (max_rounds > 0) atomicMin(claim + slot, claim_word(stamp, i));
      }
    }
    const int at = warp_append(cnt + kNElig, eligible);
    if (eligible) s.list[at] = i;
  }
  grid.sync();

  // ---- 4. election rounds: rank r = the r-th smallest index of a slot.
  // Phase r checks round r - 1's winners (they take rank r - 1 and are
  // scattered at count + rank at once: nothing later reads the rows or the
  // counts) and makes round r's claims, into the other half of the claim
  // words, so one barrier a round suffices.
  const int n_elig = cnt[kNElig];
  int open = max_rounds > 0 ? n_elig : 0;
  for (int r = 1; open > 0; ++r) {
    const unsigned long long* prev = claim + ((r - 1) & 1) * cap;
    unsigned long long* next = claim + (r & 1) * cap;
    for (int e0 = first; e0 < n_elig; e0 += stride) {
      const int e = e0 + threadIdx.x;
      bool still = false;
      if (e < n_elig) {
        const int i = s.list[e];
        const int slot = s.slot[i];
        if (s.rank[i] < 0) {
          if (prev[slot] == claim_word(stamp + r - 1, i)) {
            s.rank[i] = r - 1;
            const int pos = s.ecount[i] + r - 1;
            if (pos < p) {
              float* row = points + static_cast<size_t>(slot) * 3 * p;
              row[pos] = pts[3 * i + 0];
              row[p + pos] = pts[3 * i + 1];
              row[2 * p + pos] = pts[3 * i + 2];
              atomicAdd(count + slot, 1);
              atomicAdd(num_points, 1);
              atomicAdd(inserted, 1);
              if (rank0 && r == 1) rank0[i] = slot;
            }
          } else if (r < max_rounds) {
            atomicMin(next + slot, claim_word(stamp + r, i));
            still = true;
          }
        }
      }
      warp_count(cnt + kRemain + r, still);
    }
    grid.sync();
    open = cnt[kRemain + r];
  }

  // every block read the stamp and the set before the first barrier
  if (tid == 0) {
    ctrl[kCtrlStamp] = stamp + max_rounds;
    ctrl[kCtrlSet] = 1 - set;
  }
}

int g_max_blocks = 0;   // blocks resident together: the cooperative limit

}  // namespace

// int32 entries of the control block a caller keeps beside the claim words
extern "C" int k3_ctrl_ints() { return kCtrlInts; }
// the stamp (control block entry 0) past which a call clears the claim words
extern "C" int k3_stamp_limit() { return kStampLimit; }

// In place on (keys, count, points, num_points). scratch: int32
// [kScratchRows * n]; claim: uint64 [2 * cap] and ctrl: int32 [kCtrlInts],
// kept by the caller from call to call (claim all ones, ctrl zeros at
// first); inserted: int32 [1]; rank0: int32 [n] or null (each point's
// slot where it was accepted with election rank 0, else -1).
extern "C" int k3_map_insert(void* keys, void* count, void* points,
                             void* num_points, const void* pts,
                             const void* valid, int n, int cap, int p,
                             float resolution, float min_d2, int max_rounds,
                             void* scratch, void* claim, void* ctrl,
                             void* inserted, void* rank0, void* stream) {
  if (max_rounds < 0 || max_rounds > kMaxRounds)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g_max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, map_insert_kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_max_blocks = per_sm * sms;
  }
  int32_t* sc = static_cast<int32_t*>(scratch);
  Scratch s{sc + kSlot * n,
            reinterpret_cast<uint32_t*>(sc + kHash * n),
            reinterpret_cast<uint32_t*>(sc + kKey * n),
            sc + kFlags * n,
            sc + kEcount * n,
            sc + kRank * n,
            sc + kAttempt * n,
            sc + kList * n};
  auto* table = static_cast<uint32_t*>(keys);
  auto* cnt = static_cast<int32_t*>(count);
  auto* pt = static_cast<float*>(points);
  auto* np = static_cast<int32_t*>(num_points);
  const auto* fpts = static_cast<const float*>(pts);
  const auto* vd = static_cast<const uint8_t*>(valid);
  auto* cl = static_cast<unsigned long long*>(claim);
  auto* ct = static_cast<int32_t*>(ctrl);
  auto* ins = static_cast<int32_t*>(inserted);
  auto* r0 = static_cast<int32_t*>(rank0);
  void* args[] = {&table, &cnt, &pt, &np, &fpts, &vd, &n, &cap, &p,
                  &resolution, &min_d2, &max_rounds, &s, &cl, &ct, &ins,
                  &r0};
  const int blocks =
      std::max(1, std::min((n + kThreads - 1) / kThreads, g_max_blocks));
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(map_insert_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
