// K1 candidate_gather: voxel-map lookup + candidate selection, as slots.
//
// Replaces ct_icp_tpu/mapping/voxel_map.py::find_slots_with_count (:168) and
// ::gather_candidate_planes (:668-719) up to its row gather. It returns the
// slot of each candidate voxel (the reference's slot_c after its top_k: 0
// where the voxel is absent, the real slot where it is present but not
// usable) and its usable count, and copies no row. The TPU gathered the
// [M, O', 3P] rows because its DMA wants dense rows; on Hopper, K2 reads the
// live map points through the slots (4-byte loads from rows that stay in
// L2), and no path writes the map between a gather and its rescorings
// (ct_icp_torch/icp/solver.py).
//
// Every (query, voxel) pair hashes its voxel, loads the PROBE_WINDOW keys
// from h & (C-1) (16-byte vector loads, the later ones only where the first
// does not settle the probe; csrc/probe.cuh, shared with K9), takes the
// first key match before the first EMPTY and loads its count.
//   * All O = (2nv+1)^3 voxels (x fastest, the order of _neighbor_offsets):
//     one thread per pair; each pair writes its slot and count (8 B).
//   * With 0 < max_candidates < O (the reference's max_candidate_voxels, 48
//     of the 125 voxels of a 0.5 m map searched at radius 0.8: the robust
//     profile), one warp per query: lanes probe 32 voxels at a time into
//     shared memory, then place the kept ones in the order of the
//     reference's top_k of (usable ? 1 - |offset|^2 / 100 : -1), ties to the
//     lower index: the usable voxels, nearer offsets first (``order``, the
//     offsets sorted by (|offset|^2, index), staged in shared memory), then
//     the others by index. Each place is a warp ballot's prefix count.
// One launch either way.
//
// With the normal filter (the distance strategy's, voxel_map.py:699-703; a
// non-NULL sensor location), a hit is usable only where its voxel's normal
// is not set (nflags < 2) or faces the sensor:
//   (sensor - query) . normals[slot] >= 0,
// summed x, y, z left to right in round-to-nearest intrinsics; it reads
// normals and nflags for hits only, before the compaction. Without it the
// outputs are what they were bit for bit.
//
// Bound: bytes. The queries, each distinct probed key window once, the
// count of each distinct found slot once, 8 B written per output pair;
// there is no arithmetic to speak of (three divisions and two hashes per
// pair).
#include "common.cuh"
#include "probe.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// The reference's lookup of voxel (cx, cy, cz) (csrc/probe.cuh): slot and
// count, or hit = false (slot 0, count 0) where it is absent.
__device__ __forceinline__ bool probe(const uint32_t* __restrict__ keys,
                                      const int32_t* __restrict__ count,
                                      uint32_t cap_mask, int cx, int cy,
                                      int cz, int& slot, int& cnt) {
  const int found = cticp::probe_slot(keys, cap_mask, cx, cy, cz);
  slot = 0;
  cnt = 0;
  if (found < 0) return false;
  slot = found;
  cnt = __ldg(count + slot);
  return true;
}

// The normal filter of a hit at ``slot`` of query (qx, qy, qz); true (no
// filter) where ``sensor`` is NULL.
__device__ __forceinline__ bool faces_sensor(
    const float* __restrict__ normals, const int32_t* __restrict__ nflags,
    const float* __restrict__ sensor, int slot, float qx, float qy,
    float qz) {
  if (sensor == nullptr || __ldg(nflags + slot) < 2) return true;
  const float* nrm = normals + 3 * static_cast<size_t>(slot);
  const float dot = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(sensor[0], qx), __ldg(nrm + 0)),
                __fmul_rn(__fsub_rn(sensor[1], qy), __ldg(nrm + 1))),
      __fmul_rn(__fsub_rn(sensor[2], qz), __ldg(nrm + 2)));
  return dot >= 0.0f;
}

__global__ void candidate_lookup_kernel(
    const uint32_t* __restrict__ keys, const int32_t* __restrict__ count,
    const float* __restrict__ queries, const uint8_t* __restrict__ query_valid,
    const float* __restrict__ normals, const int32_t* __restrict__ nflags,
    const float* __restrict__ sensor, int m, uint32_t cap_mask, int nv,
    float resolution, int threshold, int32_t* __restrict__ out_slot,
    int32_t* __restrict__ out_cnt) {
  const int side = 2 * nv + 1;
  const int n_off = side * side * side;
  const long long pair =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pair >= static_cast<long long>(m) * n_off) return;
  const int qi = static_cast<int>(pair / n_off);
  const int o = static_cast<int>(pair - static_cast<long long>(qi) * n_off);
  const int cx = cticp::voxel_coord(queries[3 * qi + 0], resolution) +
                 (o % side - nv);
  const int cy = cticp::voxel_coord(queries[3 * qi + 1], resolution) +
                 ((o / side) % side - nv);
  const int cz = cticp::voxel_coord(queries[3 * qi + 2], resolution) +
                 (o / (side * side) - nv);
  int slot, cnt;
  const bool hit = probe(keys, count, cap_mask, cx, cy, cz, slot, cnt);
  const bool ok = hit && cnt >= threshold && query_valid[qi] &&
                  faces_sensor(normals, nflags, sensor, slot,
                               queries[3 * qi + 0], queries[3 * qi + 1],
                               queries[3 * qi + 2]);
  out_slot[pair] = slot;
  out_cnt[pair] = ok ? cnt : 0;
}

__global__ void candidate_select_kernel(
    const uint32_t* __restrict__ keys, const int32_t* __restrict__ count,
    const float* __restrict__ queries, const uint8_t* __restrict__ query_valid,
    const float* __restrict__ normals, const int32_t* __restrict__ nflags,
    const float* __restrict__ sensor, const int32_t* __restrict__ order,
    int m, uint32_t cap_mask, int nv, float resolution, int threshold,
    int max_c,
    int32_t* __restrict__ out_slot, int32_t* __restrict__ out_cnt) {
  extern __shared__ int32_t smem[];
  const int side = 2 * nv + 1;
  const int n_off = side * side * side;
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarpsPerBlock + wib;
  if (qi >= m) return;  // whole warp
  int32_t* sh_slot = smem + wib * 3 * n_off;
  int32_t* sh_cnt = sh_slot + n_off;  // the usable count, -1 where unusable
  int32_t* sh_order = sh_cnt + n_off;
  const float qx = queries[3 * qi + 0];
  const float qy = queries[3 * qi + 1];
  const float qz = queries[3 * qi + 2];
  const int bx = cticp::voxel_coord(qx, resolution) - nv;
  const int by = cticp::voxel_coord(qy, resolution) - nv;
  const int bz = cticp::voxel_coord(qz, resolution) - nv;
  const bool valid = query_valid[qi] != 0;
  const unsigned below = (1u << lane) - 1u;
  for (int t = lane; t < n_off; t += 32) sh_order[t] = order[t];

  int n_ok = 0;
#pragma unroll 4
  for (int base = 0; base < n_off; base += 32) {
    const int o = base + lane;
    bool ok = false;
    if (o < n_off) {
      int slot, cnt;
      const bool hit = probe(keys, count, cap_mask, bx + o % side,
                             by + (o / side) % side, bz + o / (side * side),
                             slot, cnt);
      ok = hit && cnt >= threshold && valid &&
           faces_sensor(normals, nflags, sensor, slot, qx, qy, qz);
      sh_slot[o] = slot;
      sh_cnt[o] = ok ? cnt : -1;
    }
    n_ok += __popc(__ballot_sync(0xffffffffu, ok));
  }
  __syncwarp();

  // the usable voxels, nearer offsets first
  int32_t* dst_slot = out_slot + static_cast<size_t>(qi) * max_c;
  int32_t* dst_cnt = out_cnt + static_cast<size_t>(qi) * max_c;
  int placed = 0;
  for (int base = 0; base < n_off && placed < max_c; base += 32) {
    const int t = base + lane;
    const int o = t < n_off ? sh_order[t] : 0;
    const int c = t < n_off ? sh_cnt[o] : -1;
    const unsigned bits = __ballot_sync(0xffffffffu, c >= 0);
    const int rank = placed + __popc(bits & below);
    if (c >= 0 && rank < max_c) {
      dst_slot[rank] = sh_slot[o];
      dst_cnt[rank] = c;
    }
    placed += __popc(bits);
  }
  // then the others, by index
  placed = n_ok;
  for (int base = 0; base < n_off && placed < max_c; base += 32) {
    const int o = base + lane;
    const bool other = o < n_off && sh_cnt[o] < 0;
    const unsigned bits = __ballot_sync(0xffffffffu, other);
    const int rank = placed + __popc(bits & below);
    if (other && rank < max_c) {
      dst_slot[rank] = sh_slot[o];
      dst_cnt[rank] = 0;
    }
    placed += __popc(bits);
  }
}

}  // namespace

// order: int32[O], the neighbour offsets sorted by (|offset|^2, index);
// normals f32[C, 3], nflags int32[C] and sensor f32[3]: the normal filter,
// off where sensor is NULL (normals and nflags are then not read).
extern "C" int k1_candidate_gather_compact(
    const void* keys, const void* count, const void* queries,
    const void* query_valid, const void* normals, const void* nflags,
    const void* sensor, const void* order, int m, int cap, int nv,
    float resolution, int threshold, int max_c, void* slots, void* cnt_ok,
    void* stream) {
  const int side = 2 * nv + 1;
  const int n_off = side * side * side;
  if (m > 0 && max_c > 0) {
    const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const size_t smem = sizeof(int32_t) * 3 * n_off * kWarpsPerBlock;
    candidate_select_kernel<<<blocks, 32 * kWarpsPerBlock, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(count),
        static_cast<const float*>(queries),
        static_cast<const uint8_t*>(query_valid),
        static_cast<const float*>(normals),
        static_cast<const int32_t*>(nflags),
        static_cast<const float*>(sensor),
        static_cast<const int32_t*>(order), m,
        static_cast<uint32_t>(cap - 1), nv, resolution, threshold, max_c,
        static_cast<int32_t*>(slots), static_cast<int32_t*>(cnt_ok));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k1_candidate_gather(const void* keys, const void* count,
                                   const void* queries,
                                   const void* query_valid,
                                   const void* normals, const void* nflags,
                                   const void* sensor, int m, int cap,
                                   int nv, float resolution, int threshold,
                                   void* slots, void* cnt_ok, void* stream) {
  const int side = 2 * nv + 1;
  const long long pairs = static_cast<long long>(m) * side * side * side;
  if (pairs > 0) {
    const int threads = 256;
    const long long blocks = (pairs + threads - 1) / threads;
    candidate_lookup_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(count),
        static_cast<const float*>(queries),
        static_cast<const uint8_t*>(query_valid),
        static_cast<const float*>(normals),
        static_cast<const int32_t*>(nflags),
        static_cast<const float*>(sensor), m,
        static_cast<uint32_t>(cap - 1), nv, resolution, threshold,
        static_cast<int32_t*>(slots), static_cast<int32_t*>(cnt_ok));
  }
  return static_cast<int>(cudaGetLastError());
}
