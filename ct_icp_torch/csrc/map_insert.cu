// K3 map_insert: insert a point batch into one voxel-map level, in place.
//
// Replaces the body of ct_icp_tpu/mapping/voxel_map.py::insert_points with
// with_normals=False (:366-522): _resolve_or_claim_slots (:198-305), the
// min-distance check, _elect_ranks (:327-363), the planar scatter at
// count + rank, the count add and num_points. Its claim phase is the Hopper
// counterpart of the first-wins claim table of the Pallas kernel
// tools/pallas_kernels_experiment.py:35 (dedup_compact).
//
// One thread per point; every phase is a launch on the caller's stream, and
// a round is two launches (a grid-wide barrier between the atomicMin of all
// claimants and the winners' check), so no round syncs with the host. Every
// round is launched and resolved threads exit at once — the reference's
// all-resolved early exit changes nothing but the work done.
//
// Arbitration is bit-exact with the reference: a claim round is an
// atomicMin of the ORIGINAL scan index over the EMPTY/TOMB slots its
// claimants probe (MAX_PROBES = 16 rounds); an election round is an
// atomicMin of the point index over each slot (max_rounds rounds). The
// reference elects on the compacted eligible index, whose order equals the
// scan order, so the winners are the same. Never atomicCAS first-come: its
// winner depends on timing. The claim words are 64-bit: the high half is a
// per-round stamp that decreases from round to round, so a round's claims
// always beat the leftovers of earlier rounds and the table is cleared
// only once per call.
//
// Bound: the min-distance check, which reads the existing rows of every
// point's voxel (N x 3P floats, gathered); claim and election rounds touch
// a few words per unresolved point.
#include "common.cuh"

namespace {

// scratch rows (int32 [kScratchRows, n])
enum : int {
  kSlot = 0, kHash, kKey, kFlags, kEcount, kRank, kAttempt, kScratchRows
};
// kFlags bits
constexpr int kValid = 1, kResolved = 2, kEligible = 4;

struct Scratch {
  int32_t* slot;
  uint32_t* hash;
  uint32_t* key;
  int32_t* flags;
  int32_t* ecount;
  int32_t* rank;
  int32_t* attempt;
};

__device__ __forceinline__ unsigned long long claim_word(int stamp, int pid) {
  return (static_cast<unsigned long long>(0xffffffffu - stamp) << 32) |
         static_cast<uint32_t>(pid);
}

// Phase 1: the probe-window lookup of the existing voxel (PROBE_WINDOW).
__global__ void resolve_kernel(const uint32_t* __restrict__ table,
                               const float* __restrict__ pts,
                               const uint8_t* __restrict__ valid, int n,
                               uint32_t cap_mask, float resolution,
                               Scratch s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int cx = cticp::voxel_coord(pts[3 * i + 0], resolution);
  const int cy = cticp::voxel_coord(pts[3 * i + 1], resolution);
  const int cz = cticp::voxel_coord(pts[3 * i + 2], resolution);
  const uint32_t h = cticp::voxel_hash_u32(cx, cy, cz);
  const uint32_t key = cticp::voxel_key_u32(cx, cy, cz);
  s.hash[i] = h;
  s.key[i] = key;
  s.attempt[i] = -1;
  s.rank[i] = -1;
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
}

// Claim round r, first half: the re-read of round r-1's slot (a same-voxel
// loser resolves to the winner's key), then round r's probe: an existing
// key resolves, an EMPTY/TOMB slot takes this point's claim.
__global__ void claim_attempt_kernel(const uint32_t* __restrict__ table,
                                     unsigned long long* __restrict__ claim,
                                     int n, uint32_t cap_mask, int r,
                                     int stamp, Scratch s) {
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
  if (r >= cticp::kMaxProbes) return;
  const uint32_t at = (h + static_cast<uint32_t>(r)) & cap_mask;
  const uint32_t k = table[at];
  if (k == key) {
    s.slot[i] = static_cast<int>(at);
    s.flags[i] |= kResolved;
    return;
  }
  if (k == cticp::kEmpty || k == cticp::kTomb) {
    atomicMin(claim + at, claim_word(stamp, i));
    s.attempt[i] = r;
  }
}

// Claim round r, second half: the winner of each claimed slot writes its key.
__global__ void claim_write_kernel(uint32_t* __restrict__ table,
                                   const unsigned long long* __restrict__ claim,
                                   int n, uint32_t cap_mask, int r, int stamp,
                                   Scratch s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || s.flags[i] != kValid || s.attempt[i] != r) return;
  const uint32_t at = (s.hash[i] + static_cast<uint32_t>(r)) & cap_mask;
  if (claim[at] == claim_word(stamp, i)) table[at] = s.key[i];
}

// Min-distance check against the voxel's existing points; eligibility.
__global__ void mindist_kernel(const int32_t* __restrict__ count,
                               const float* __restrict__ points,
                               const float* __restrict__ pts, int n, int p,
                               float min_d2, Scratch s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int flags = s.flags[i];
  const bool resolved = flags & kResolved;
  const int slot = resolved ? s.slot[i] : 0;
  const int ec = count[slot];
  const float* row = points + static_cast<size_t>(slot) * 3 * p;
  const float px = pts[3 * i + 0], py = pts[3 * i + 1], pz = pts[3 * i + 2];
  float best = __int_as_float(0x7f800000);
  for (int j = 0; j < ec && j < p; ++j) {
    const float dx = row[j] - px, dy = row[p + j] - py,
                dz = row[2 * p + j] - pz;
    best = fminf(best, dx * dx + dy * dy + dz * dz);
  }
  const bool far_enough = ec == 0 || best > min_d2;
  s.ecount[i] = ec;
  s.slot[i] = slot;
  if (resolved && far_enough && ec < p) s.flags[i] = flags | kEligible;
}

__global__ void elect_claim_kernel(unsigned long long* __restrict__ claim,
                                   int n, int stamp, Scratch s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !(s.flags[i] & kEligible) || s.rank[i] >= 0) return;
  atomicMin(claim + s.slot[i], claim_word(stamp, i));
}

__global__ void elect_rank_kernel(const unsigned long long* __restrict__ claim,
                                  int n, int r, int stamp, Scratch s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !(s.flags[i] & kEligible) || s.rank[i] >= 0) return;
  if (claim[s.slot[i]] == claim_word(stamp, i)) s.rank[i] = r;
}

// Planar scatter at count + rank, count add, num_points.
__global__ void scatter_kernel(int32_t* __restrict__ count,
                               float* __restrict__ points,
                               int32_t* __restrict__ num_points,
                               int32_t* __restrict__ inserted,
                               const float* __restrict__ pts, int n, int p,
                               Scratch s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !(s.flags[i] & kEligible) || s.rank[i] < 0) return;
  const int pos = s.ecount[i] + s.rank[i];
  if (pos >= p) return;
  const int slot = s.slot[i];
  float* row = points + static_cast<size_t>(slot) * 3 * p;
  row[pos] = pts[3 * i + 0];
  row[p + pos] = pts[3 * i + 1];
  row[2 * p + pos] = pts[3 * i + 2];
  atomicAdd(count + slot, 1);
  atomicAdd(num_points, 1);
  atomicAdd(inserted, 1);
}

}  // namespace

// In place on (keys, count, points, num_points). scratch: int32
// [kScratchRows * n]; claim: uint64 [cap]; inserted: int32 [1].
extern "C" int k3_map_insert(void* keys, void* count, void* points,
                             void* num_points, const void* pts,
                             const void* valid, int n, int cap, int p,
                             float resolution, float min_d2, int max_rounds,
                             void* scratch, void* claim, void* inserted,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(inserted, 0, sizeof(int32_t), st);
  if (n > 0) {
    int32_t* sc = static_cast<int32_t*>(scratch);
    Scratch s{sc + kSlot * n,
              reinterpret_cast<uint32_t*>(sc + kHash * n),
              reinterpret_cast<uint32_t*>(sc + kKey * n),
              sc + kFlags * n,
              sc + kEcount * n,
              sc + kRank * n,
              sc + kAttempt * n};
    uint32_t* table = static_cast<uint32_t*>(keys);
    auto* cl = static_cast<unsigned long long*>(claim);
    const auto* fpts = static_cast<const float*>(pts);
    const uint32_t cap_mask = static_cast<uint32_t>(cap - 1);
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    cudaMemsetAsync(claim, 0xff, sizeof(unsigned long long) * cap, st);
    resolve_kernel<<<blocks, threads, 0, st>>>(
        table, fpts, static_cast<const uint8_t*>(valid), n, cap_mask,
        resolution, s);
    int stamp = 0;
    for (int r = 0; r < cticp::kMaxProbes; ++r, ++stamp) {
      claim_attempt_kernel<<<blocks, threads, 0, st>>>(table, cl, n, cap_mask,
                                                       r, stamp, s);
      claim_write_kernel<<<blocks, threads, 0, st>>>(table, cl, n, cap_mask,
                                                     r, stamp, s);
    }
    // the re-read of the last round's slot
    claim_attempt_kernel<<<blocks, threads, 0, st>>>(
        table, cl, n, cap_mask, cticp::kMaxProbes, stamp, s);
    mindist_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const int32_t*>(count), static_cast<const float*>(points),
        fpts, n, p, min_d2, s);
    for (int r = 0; r < max_rounds; ++r, ++stamp) {
      elect_claim_kernel<<<blocks, threads, 0, st>>>(cl, n, stamp, s);
      elect_rank_kernel<<<blocks, threads, 0, st>>>(cl, n, r, stamp, s);
    }
    scatter_kernel<<<blocks, threads, 0, st>>>(
        static_cast<int32_t*>(count), static_cast<float*>(points),
        static_cast<int32_t*>(num_points), static_cast<int32_t*>(inserted),
        fpts, n, p, s);
  }
  return static_cast<int>(cudaGetLastError());
}
