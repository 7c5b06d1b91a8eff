// K13 exact_sample: up to k points a voxel, grouped by the exact voxel key,
// kept in scan order.
//
// Replaces no Pallas kernel: the JAX package's exact samplers are XLA
// lexsorts, ct_icp_tpu/ops/sampling.py:61::voxel_subsample_indices_exact,
// :73::voxel_sample_k_indices and :89::adaptive_grid_sampling_indices (the
// ADAPTIVE keypoints of the staged per-frame path, run once an attempt).
// It computes what they compute, without a sort:
//
//   0. each valid point derives its key (band, trunc(x/s), trunc(y/s),
//      trunc(z/s)): without bands the band is 0 and s the voxel size; with
//      bands the range d = sqrt(fma(z, z, fma(y, y, x*x))) (the JAX
//      package's jnp.linalg.norm, which XLA contracts into these two FMAs
//      on the CPU), the band the edges below d less one, clipped, and s its
//      size (1 where that size is <= 0); a point outside [edge0, edgeB-1)
//      is dropped;
//   1. one insert pass, with no grid barrier in it, over a table of
//      2^table_log2 >= 4N slots: each point probes linearly from its
//      key's hash. A slot's 64-bit claim word carries this call's stamp
//      once a point owns it this call. A word of an earlier call marks the
//      slot free: the first point to arrive takes it by atomicCAS to its
//      own election word, writes its 16-byte key and publishes the call's
//      stamp in the slot's stamp word with a release store. A point that
//      finds the slot owned waits (acquire loads) until the stamp word
//      reads this call's stamp, then compares all four words of the key:
//      an equal key resolves it, another key moves it on. The points of one
//      key probe the same slots, so all of them resolve to the slot its
//      first arrival took, and no two distinct keys ever merge. A waiter
//      may wait on a lane of its own warp: independent thread scheduling
//      (sm_70 and later) lets the owner's lane run on meanwhile, and the
//      owner publishes right after its claim, waiting on nothing;
//   2. the election, in the same pass: the resolved points of a slot
//      atomicMin their election words (this call's stamp over the scan
//      index) into its claim word, one atomic for the lanes of a warp that
//      share the slot (__match_any_sync; the lowest lane holds the lowest
//      index). Which point claims a slot depends on the order of arrival;
//      the word left after the pass is the key's lowest index whatever the
//      order: its rank-0 point. After the one grid barrier a point is kept
//      iff the claim word is its own;
//   3. k - 1 rank rounds: the unelected points of each slot atomicMin a
//      word of round j over their scan index into the slot's claim word;
//      round j elects each key's j-th point (its rank: the valid, in-range
//      points before it with its key);
//   4. the kept points compacted in scan order (csrc/compact.cuh, as K4's
//      are), cut at min(max_keep, capacity) (max_keep <= 0: capacity
//      alone); idx and out_valid past the count are zero.
// At k = 1 that is two grid barriers a call (after the insert pass, and
// the compaction's); each rank round adds two.
//
// One cooperative launch of resident blocks, each owning a run of
// 256-point tiles; a thread keeps its first tile's slot and every tile's
// kept bit in registers (the slots of later tiles go to a 4-byte-a-point
// scratch the caller gives). The table (64-bit claim words, keys, stamps)
// persists per device and size with the last stamp: a call takes the next
// stamp, and its words, of rank round j, carry 0xffffffff - (stamp * kMaxK
// + j) in their high half, so they beat every word of an earlier call or
// round, and a slot counts as owned only where its claim word carries this
// call's round-0 half. No call clears the table but the one after stamp
// k13_stamp_limit().
//
// Bound: bytes. The function reads the points and their validity once
// (13 B a point) and writes idx, out_valid and the count (5 B a slot of the
// capacity, 4 B), as K4's bound is counted; the table and the scratch are
// this design's and are not counted. What sets the time is latency, not
// bytes: the grid barriers and the dependent claim-then-read of random
// table words. The design keeps both to one pass and two barriers, where
// claim rounds between barriers took two barriers a round. Arithmetic in
// round-to-nearest intrinsics (and the file is built with -fmad=false), so
// the kernel's keys are its plain version's bit for bit.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "compact.cuh"

namespace cg = cooperative_groups;

namespace {

using Word = unsigned long long;

constexpr int kThreads = 256;
constexpr int kMaxTiles = 64;              // tiles of kThreads points a block
constexpr int kMaxBlocks = 8192;           // entries of the block counts
constexpr int kMaxBands = 16;
constexpr int kMaxK = 64;                  // rank rounds a stamp spans
constexpr int kStampLimit =
    static_cast<int>((0xffffffffLL - (kMaxK - 1)) / kMaxK);
constexpr int kDropped = -1;
constexpr unsigned kFull = 0xffffffffu;

struct Bands {
  int n;                                   // 0: one voxel size, no bands
  float edge[kMaxBands];
  float size[kMaxBands];
};

__device__ __forceinline__ Word word_of(int stamp, int round, int i) {
  const uint32_t hi = 0xffffffffu - (static_cast<uint32_t>(stamp) * kMaxK +
                                     static_cast<uint32_t>(round));
  return (static_cast<Word>(hi) << 32) | static_cast<uint32_t>(i);
}

// the key (band, cx, cy, cz) of point i; false where it is out of range
__device__ __forceinline__ bool point_key(const float* __restrict__ pts,
                                          int i, float voxel,
                                          const Bands& b, int4* key) {
  const float x = pts[3 * i + 0], y = pts[3 * i + 1], z = pts[3 * i + 2];
  int band = 0;
  float s = voxel;
  if (b.n > 0) {
    const float d = __fsqrt_rn(
        __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x))));
    if (!(d >= b.edge[0] && d < b.edge[b.n - 1])) return false;
    int below = 0;
    for (int e = 0; e < b.n; ++e) below += b.edge[e] < d ? 1 : 0;
    band = min(max(below - 1, 0), b.n - 1);
    s = b.size[band];
    if (!(s > 0.0f)) s = 1.0f;
  }
  *key = make_int4(band, static_cast<int>(truncf(__fdiv_rn(x, s))),
                   static_cast<int>(truncf(__fdiv_rn(y, s))),
                   static_cast<int>(truncf(__fdiv_rn(z, s))));
  return true;
}

__device__ __forceinline__ uint32_t key_hash(int4 k) {
  uint32_t h = static_cast<uint32_t>(k.x) * 2654435761u;
  h ^= cticp::voxel_hash_u32(k.y, k.z, k.w);
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool same_key(int4 a, int4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

// The stamp word's publication: the owner's key is written before it
// (release), and a waiter's reads of the key come after it (acquire).
__device__ __forceinline__ int load_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Arrays shared across blocks (claim, tkey, tstamp, ctrl, block_cnt) carry
// no __restrict__/const and are read through the L2 (__ldcg, or the
// acquire load); the slot scratch is read and written by its own thread
// only.
__global__ void __launch_bounds__(kThreads)
    exact_sample_kernel(const float* __restrict__ pts,
                        const uint8_t* __restrict__ valid, int n, float voxel,
                        Bands bands, int k, int max_keep, int capacity,
                        uint32_t mask, int tiles_per_block, Word* claim,
                        int4* tkey, int32_t* tstamp, int32_t* ctrl,
                        int32_t* block_cnt, int32_t* __restrict__ pslot,
                        int32_t* __restrict__ idx,
                        uint8_t* __restrict__ out_valid,
                        int32_t* __restrict__ count) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int tile0 = blockIdx.x * tiles_per_block;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;

  // every block reads the last stamp before the first barrier
  int stamp = ctrl[0];
  if (stamp >= kStampLimit) {                  // every block agrees
    for (long long j = tid; j <= static_cast<long long>(mask); j += stride) {
      claim[j] = ~Word(0);
      tstamp[j] = 0;
    }
    stamp = 0;
    grid.sync();
  }
  ++stamp;
  // the high half of this call's insert words: a claim word that carries
  // it is owned this call, any other is an earlier call's (larger)
  const uint32_t owned_hi = static_cast<uint32_t>(word_of(stamp, 0, 0) >> 32);

  int slot0 = kDropped;             // tile 0's slot; later tiles' in pslot
  unsigned long long kept = 0;      // bit t: the thread's point of tile t
  auto slot_of = [&](int t, int i) {
    return i >= n ? kDropped : (t == 0 ? slot0 : pslot[i]);
  };

  // ---- 0-2. keys, the insert pass and the election, no barrier
  for (int t = 0; t < tiles_per_block; ++t) {
    const int i = (tile0 + t) * kThreads + threadIdx.x;
    int4 key;
    const bool ok = i < n && valid[i] && point_key(pts, i, voxel, bands, &key);
    int slot = kDropped;
    bool owner = false;
    if (ok) {
      const Word mine = word_of(stamp, 0, i);
      uint32_t at = key_hash(key) & mask;
      for (uint32_t probe = 0;; ++probe, at = (at + 1) & mask) {
        if (probe > mask) __trap();       // T > n: never
        const Word seen = __ldcg(claim + at);
        if (static_cast<uint32_t>(seen >> 32) != owned_hi &&
            atomicCAS(claim + at, seen, mine) == seen) {
          tkey[at] = key;
          store_release(tstamp + at, stamp);
          slot = static_cast<int>(at);
          owner = true;
          break;
        }
        // owned this call (or taken since the read): its key, once ready
        while (load_acquire(tstamp + at) != stamp) {
        }
        if (same_key(__ldcg(tkey + at), key)) {
          slot = static_cast<int>(at);
          break;
        }
      }
    }
    // one atomicMin for the lanes that share a slot: the lowest lane's
    // index is the lowest; the owner's word is in already
    const unsigned same = __match_any_sync(kFull, slot);
    if (slot >= 0 && lane == __ffs(same) - 1 && !owner)
      atomicMin(claim + slot, word_of(stamp, 0, i));
    if (t == 0)
      slot0 = slot;
    else if (i < n)
      pslot[i] = slot;
  }
  grid.sync();
  if (tid == 0) ctrl[0] = stamp;
  // rank 0: the claim word holds the key's earliest point
  for (int t = 0; t < tiles_per_block; ++t) {
    const int i = (tile0 + t) * kThreads + threadIdx.x;
    const int s = slot_of(t, i);
    if (s >= 0 && __ldcg(claim + s) == word_of(stamp, 0, i))
      kept |= 1ull << t;
  }

  // ---- 3. rank rounds: round j elects each key's j-th point
  for (int j = 1; j < k; ++j) {
    grid.sync();                      // round j-1's reads before these
    for (int t = 0; t < tiles_per_block; ++t) {
      const int i = (tile0 + t) * kThreads + threadIdx.x;
      const int s = slot_of(t, i);
      if (s >= 0 && !((kept >> t) & 1ull))
        atomicMin(claim + s, word_of(stamp, j, i));
    }
    grid.sync();
    for (int t = 0; t < tiles_per_block; ++t) {
      const int i = (tile0 + t) * kThreads + threadIdx.x;
      const int s = slot_of(t, i);
      if (s >= 0 && !((kept >> t) & 1ull) &&
          __ldcg(claim + s) == word_of(stamp, j, i))
        kept |= 1ull << t;
    }
  }

  // ---- 4. the kept points compacted in scan order: csrc/compact.cuh
  const int cut = max_keep > 0 ? min(max_keep, capacity) : capacity;
  cticp::compact_in_scan_order<kThreads, kMaxTiles>(
      grid, [&](int i) { return ((kept >> (i / kThreads - tile0)) & 1ull); },
      n, tiles_per_block, cut, capacity, block_cnt, idx, out_valid, count);
}

int g_max_blocks = 0;   // blocks resident together: the cooperative limit

}  // namespace

// the last stamp before a call clears the table, the most bands, the
// largest k, and the int32 entries of the block counts
extern "C" int k13_stamp_limit() { return kStampLimit; }
extern "C" int k13_max_bands() { return kMaxBands; }
extern "C" int k13_max_k() { return kMaxK; }
extern "C" int k13_block_ints() { return kMaxBlocks; }

// points: f32 [n, 3]; valid: u8 [n]; voxel: the voxel size where n_bands
// is 0, else edges / sizes: n_bands host floats each; claim: uint64
// [2^table_log2] (all ones at first), tkey: int4 [2^table_log2], tstamp:
// int32 [2^table_log2] (0 at first) and ctrl: int32 [1] (the last stamp,
// 0 at first), kept by the caller from call to call; block_cnt: int32
// [k13_block_ints()]; scratch: int32 [n]; idx: int32 [capacity],
// out_valid: u8 [capacity], count: int32 [1].
extern "C" int k13_exact_sample(const void* points, const void* valid, int n,
                                float voxel, const float* edges,
                                const float* sizes, int n_bands, int k,
                                int max_keep, int table_log2, int capacity,
                                void* claim, void* tkey, void* tstamp,
                                void* ctrl, void* block_cnt, void* scratch,
                                void* idx, void* out_valid, void* count,
                                void* stream) {
  if (n < 0 || capacity < 0 || k < 1 || k > kMaxK || n_bands < 0 ||
      n_bands > kMaxBands || table_log2 < 2 ||
      table_log2 > 30 || (1LL << table_log2) <= n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g_max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, exact_sample_kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_max_blocks = std::min(per_sm * sms, kMaxBlocks);
  }
  const int n_tiles = (n + kThreads - 1) / kThreads;
  int tiles = 0, blocks = 1;
  if (n_tiles > 0) {
    tiles = (n_tiles + g_max_blocks - 1) / g_max_blocks;
    blocks = (n_tiles + tiles - 1) / tiles;
  }
  if (tiles > kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  Bands b{};
  b.n = n_bands;
  for (int e = 0; e < n_bands; ++e) {
    b.edge[e] = edges[e];
    b.size[e] = sizes[e];
  }
  const auto* p = static_cast<const float*>(points);
  const auto* v = static_cast<const uint8_t*>(valid);
  uint32_t mask = static_cast<uint32_t>((1LL << table_log2) - 1);
  auto* cl = static_cast<Word*>(claim);
  auto* tk = static_cast<int4*>(tkey);
  auto* ts = static_cast<int32_t*>(tstamp);
  auto* ct = static_cast<int32_t*>(ctrl);
  auto* bc = static_cast<int32_t*>(block_cnt);
  auto* ps = static_cast<int32_t*>(scratch);
  auto* out = static_cast<int32_t*>(idx);
  auto* ov = static_cast<uint8_t*>(out_valid);
  auto* cnt = static_cast<int32_t*>(count);
  void* args[] = {&p,  &v,  &n,  &voxel, &b,  &k,  &max_keep,
                  &capacity, &mask, &tiles, &cl, &tk, &ts, &ct,
                  &bc, &ps, &out, &ov, &cnt};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(exact_sample_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
