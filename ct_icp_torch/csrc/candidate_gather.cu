// K1 candidate_gather: voxel-map lookup + candidate row gather.
//
// Replaces ct_icp_tpu/mapping/voxel_map.py::find_slots_with_count (:168) and
// ::gather_candidate_planes (:668-719); its gather half is the Hopper
// counterpart of the Pallas per-row DMA gather tools/exp_gather.py:90.
//
// For M queries x O = (2nv+1)^3 neighbour voxels (x fastest, the order of
// _neighbor_offsets), each warp owns one (query, voxel) pair: lanes 0..7
// read the PROBE_WINDOW keys from h & (C-1) in one coalesced load, two
// ballots find the first key match before the first EMPTY, and then all 32
// lanes copy the voxel's planar 3P-float row (x | y | z planes). Absent
// voxels copy row 0 with a zero count, as the reference gathers slot 0.
//
// Bound: bytes. Per pair it reads 8 keys + 1 count + one 3P row and writes
// one 3P row + one count; no arithmetic to speak of. The rolled [C, 2R]
// probe window of the TPU design is dropped: a direct probe reads the same
// 32 bytes of keys per pair and needs no window rebuild after each insert.
#include "common.cuh"

namespace {

__global__ void candidate_gather_kernel(
    const uint32_t* __restrict__ keys, const int32_t* __restrict__ count,
    const float* __restrict__ points, const float* __restrict__ queries,
    const uint8_t* __restrict__ query_valid, int m, uint32_t cap_mask,
    int row_len, int nv, float resolution, int threshold,
    float* __restrict__ rows, int32_t* __restrict__ cnt_ok) {
  const int side = 2 * nv + 1;
  const int n_off = side * side * side;
  const long long pair =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= static_cast<long long>(m) * n_off) return;  // whole warp
  const int qi = static_cast<int>(pair / n_off);
  const int o = static_cast<int>(pair - static_cast<long long>(qi) * n_off);

  const int cx = cticp::voxel_coord(queries[3 * qi + 0], resolution) +
                 (o % side - nv);
  const int cy = cticp::voxel_coord(queries[3 * qi + 1], resolution) +
                 ((o / side) % side - nv);
  const int cz = cticp::voxel_coord(queries[3 * qi + 2], resolution) +
                 (o / (side * side) - nv);
  const uint32_t h = cticp::voxel_hash_u32(cx, cy, cz);
  const uint32_t k2 = cticp::voxel_key_u32(cx, cy, cz);

  bool is_empty = false, is_match = false;
  if (lane < cticp::kProbeWindow) {
    const uint32_t key = keys[(h + lane) & cap_mask];
    is_empty = key == cticp::kEmpty;
    is_match = key == k2;
  }
  const unsigned empty_bits = __ballot_sync(0xffffffffu, is_empty);
  const unsigned match_bits = __ballot_sync(0xffffffffu, is_match);
  const unsigned before_empty =
      empty_bits ? ((1u << (__ffs(empty_bits) - 1)) - 1u) : 0xffffffffu;
  const unsigned hit = match_bits & before_empty;

  int slot = 0, cnt = 0;
  if (hit) {
    slot = static_cast<int>((h + static_cast<uint32_t>(__ffs(hit) - 1)) &
                            cap_mask);
    cnt = count[slot];
  }
  const float* src = points + static_cast<size_t>(slot) * row_len;
  float* dst = rows + static_cast<size_t>(pair) * row_len;
  for (int i = lane; i < row_len; i += 32) dst[i] = src[i];
  if (lane == 0) {
    const bool ok = hit && cnt >= threshold && query_valid[qi];
    cnt_ok[pair] = ok ? cnt : 0;
  }
}

}  // namespace

extern "C" int k1_candidate_gather(const void* keys, const void* count,
                                   const void* points, const void* queries,
                                   const void* query_valid, int m, int cap,
                                   int row_len, int nv, float resolution,
                                   int threshold, void* rows, void* cnt_ok,
                                   void* stream) {
  const int side = 2 * nv + 1;
  const long long pairs = static_cast<long long>(m) * side * side * side;
  if (pairs > 0) {
    const int threads = 256;
    const long long blocks = (pairs * 32 + threads - 1) / threads;
    candidate_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(count),
        static_cast<const float*>(points), static_cast<const float*>(queries),
        static_cast<const uint8_t*>(query_valid), m,
        static_cast<uint32_t>(cap - 1), row_len, nv, resolution, threshold,
        static_cast<float*>(rows), static_cast<int32_t*>(cnt_ok));
  }
  return static_cast<int>(cudaGetLastError());
}
