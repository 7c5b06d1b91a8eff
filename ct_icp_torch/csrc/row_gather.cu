// K6 row_gather: out[i] = table[slots[i]] - sub for 0 <= slots[i] < C, and a
// zero row otherwise.
//
// Replaces tools/exp_gather.py:90::dma_gather_kernel, the Pallas row gather
// (one DMA per row, a ring of 8 copies in flight, a grid of N / 512 blocks of
// 512 rows), and on the path the row move of
// ct_icp_tpu/mapping/voxel_map.py::rebuild_level (:641-648), written there as
// the scatter zeros.at[dst].set(rows) and here as the gather
// out[s] = rows[src[s]] (src from K7 rebuild_claim).
//
// The table is [C, W] of 4-byte elements (f32 or int32), row-contiguous.
// `sub`, when given, is an f32 row [W] subtracted from every gathered row
// (the rebase's shift repeated per plane); without it the copy is of bits,
// whatever the element type.
//
// Design: the output is cut into 16-byte chunks where W * 4 % 16 == 0 (and
// the pointers allow it), else 4-byte chunks, and consecutive threads take
// consecutive chunks of a row: one warp a row of 512 B at W = 128, a few
// warps a 360 B row (W = 90), many rows a warp at W = 1. A thread reads its
// row's slot (one load a warp, the rest hit the same line) and moves its
// chunk; a grid-stride loop covers every row, so rows past the last whole
// block of 512 are gathered too (the Pallas grid of N // 512 blocks leaves
// them unwritten). Bound: bytes, 2 x N x W x 4 at 3.35 TB/s; the loads are
// random rows, so each row costs a DRAM burst per 32 B sector it touches.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int kVec, bool kSub>
__global__ void row_gather_kernel(const uint32_t* __restrict__ table,
                                  const int32_t* __restrict__ slots,
                                  const float* __restrict__ sub,
                                  uint32_t* __restrict__ out, long long n,
                                  int c, int w) {
  const int chunks = w / kVec;                 // chunks of a row
  const long long total = n * chunks;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long i = t / chunks;
    const int j = static_cast<int>(t - i * chunks) * kVec;
    const int s = slots[i];
    uint32_t* dst = out + i * w + j;
    if constexpr (kVec == 4) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s >= 0 && s < c) {
        v = *reinterpret_cast<const uint4*>(table +
                                            static_cast<long long>(s) * w + j);
        if (kSub) {
          const float4 d = *reinterpret_cast<const float4*>(sub + j);
          v.x = __float_as_uint(__uint_as_float(v.x) - d.x);
          v.y = __float_as_uint(__uint_as_float(v.y) - d.y);
          v.z = __float_as_uint(__uint_as_float(v.z) - d.z);
          v.w = __float_as_uint(__uint_as_float(v.w) - d.w);
        }
      }
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      uint32_t v = 0u;
      if (s >= 0 && s < c) {
        v = table[static_cast<long long>(s) * w + j];
        if (kSub) v = __float_as_uint(__uint_as_float(v) - sub[j]);
      }
      *dst = v;
    }
  }
}

template <int kVec>
void launch(const uint32_t* table, const int32_t* slots, const float* sub,
            uint32_t* out, long long n, int c, int w, cudaStream_t st) {
  const int threads = 256;
  const long long total = n * (w / kVec);
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;    // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  if (sub != nullptr)
    row_gather_kernel<kVec, true><<<static_cast<int>(blocks), threads, 0,
                                    st>>>(table, slots, sub, out, n, c, w);
  else
    row_gather_kernel<kVec, false><<<static_cast<int>(blocks), threads, 0,
                                     st>>>(table, slots, sub, out, n, c, w);
}

}  // namespace

// table: 4-byte elements [c, w]; slots: int32 [n]; sub: f32 [w] or null;
// out: [n, w]. vec4: 1 to move 16-byte chunks (w % 4 == 0 and the table,
// out and sub pointers 16-byte aligned, checked by the caller).
extern "C" int k6_row_gather(const void* table, const void* slots,
                             const void* sub, void* out, long long n, int c,
                             int w, int vec4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && w > 0) {
    const auto* tb = static_cast<const uint32_t*>(table);
    const auto* sl = static_cast<const int32_t*>(slots);
    const auto* sb = static_cast<const float*>(sub);
    auto* o = static_cast<uint32_t*>(out);
    if (vec4)
      launch<4>(tb, sl, sb, o, n, c, w, st);
    else
      launch<1>(tb, sl, sb, o, n, c, w, st);
  }
  return static_cast<int>(cudaGetLastError());
}
