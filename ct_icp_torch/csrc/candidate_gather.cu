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
//
// With max_candidates < O (the reference's max_candidate_voxels, 48 of the
// 125 voxels of a 0.5 m map searched at radius 0.8: the robust profile), a
// first launch probes every (query, voxel) pair, one block per query and one
// thread per voxel, and keeps the first max_candidates voxels in the order
// of the reference's top_k: usable voxels before the others, then the
// nearer offset, then the lower index (keys are distinct, so a rank count in
// shared memory places each kept voxel); a second launch copies the kept
// rows, one warp per (query, kept voxel).
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

__global__ void candidate_select_kernel(
    const uint32_t* __restrict__ keys, const int32_t* __restrict__ count,
    const float* __restrict__ queries, const uint8_t* __restrict__ query_valid,
    uint32_t cap_mask, int nv, float resolution, int threshold, int max_c,
    int32_t* __restrict__ sel_slot, int32_t* __restrict__ sel_cnt) {
  __shared__ uint32_t order_key[1024];
  const int side = 2 * nv + 1;
  const int n_off = side * side * side;
  const int qi = blockIdx.x;
  const int o = threadIdx.x;
  int slot = 0, cnt = 0;
  bool ok = false;
  if (o < n_off) {
    const int dx = o % side - nv, dy = (o / side) % side - nv,
              dz = o / (side * side) - nv;
    const int cx = cticp::voxel_coord(queries[3 * qi + 0], resolution) + dx;
    const int cy = cticp::voxel_coord(queries[3 * qi + 1], resolution) + dy;
    const int cz = cticp::voxel_coord(queries[3 * qi + 2], resolution) + dz;
    const uint32_t h = cticp::voxel_hash_u32(cx, cy, cz);
    const uint32_t k2 = cticp::voxel_key_u32(cx, cy, cz);
    bool hit = false;
    for (int p = 0; p < cticp::kProbeWindow; ++p) {
      const uint32_t at = (h + static_cast<uint32_t>(p)) & cap_mask;
      const uint32_t key = keys[at];
      if (key == cticp::kEmpty) break;
      if (key == k2) {
        slot = static_cast<int>(at);
        hit = true;
        break;
      }
    }
    if (hit) cnt = count[slot];
    ok = hit && cnt >= threshold && query_valid[qi];
    const uint32_t d2 = static_cast<uint32_t>(dx * dx + dy * dy + dz * dz);
    order_key[o] = (ok ? 0u : 1u) << 24 | d2 << 12 | static_cast<uint32_t>(o);
  }
  __syncthreads();
  if (o < n_off) {
    const uint32_t mine = order_key[o];
    int rank = 0;
    for (int q = 0; q < n_off; ++q) rank += order_key[q] < mine;
    if (rank < max_c) {
      sel_slot[qi * max_c + rank] = slot;
      sel_cnt[qi * max_c + rank] = ok ? cnt : 0;
    }
  }
}

__global__ void candidate_rows_kernel(const float* __restrict__ points,
                                      const int32_t* __restrict__ sel_slot,
                                      long long pairs, int row_len,
                                      float* __restrict__ rows) {
  const long long pair =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= pairs) return;
  const float* src = points + static_cast<size_t>(sel_slot[pair]) * row_len;
  float* dst = rows + static_cast<size_t>(pair) * row_len;
  for (int i = lane; i < row_len; i += 32) dst[i] = src[i];
}

}  // namespace

extern "C" int k1_candidate_gather_compact(
    const void* keys, const void* count, const void* points,
    const void* queries, const void* query_valid, int m, int cap, int row_len,
    int nv, float resolution, int threshold, int max_c, void* rows,
    void* cnt_ok, void* sel_slot, void* stream) {
  const int side = 2 * nv + 1;
  const int n_off = side * side * side;
  if (m > 0 && max_c > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = (n_off + 31) / 32 * 32;
    candidate_select_kernel<<<m, threads, 0, s>>>(
        static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(count),
        static_cast<const float*>(queries),
        static_cast<const uint8_t*>(query_valid),
        static_cast<uint32_t>(cap - 1), nv, resolution, threshold, max_c,
        static_cast<int32_t*>(sel_slot), static_cast<int32_t*>(cnt_ok));
    const long long pairs = static_cast<long long>(m) * max_c;
    const long long blocks = (pairs * 32 + 255) / 256;
    candidate_rows_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const float*>(points),
        static_cast<const int32_t*>(sel_slot), pairs, row_len,
        static_cast<float*>(rows));
  }
  return static_cast<int>(cudaGetLastError());
}

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
