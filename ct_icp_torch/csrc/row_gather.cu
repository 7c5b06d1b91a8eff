// K6 row_gather: out[i] = table[slots[i]] - sub for 0 <= slots[i] < C, and a
// zero row otherwise, for one table or for several tables at the same slots
// in one launch.
//
// Replaces tools/exp_gather.py:90::dma_gather_kernel, the Pallas row gather
// (one DMA per row, a ring of 8 copies in flight, a grid of N / 512 blocks of
// 512 rows), and on the path the row move of
// ct_icp_tpu/mapping/voxel_map.py::rebuild_level (:641-648), written there as
// the scatter zeros.at[dst].set(rows) and here as the gather
// out[s] = rows[src[s]] (src from K7 rebuild_claim): the points minus the
// shift, the normals, the counts and the flags of every slot in one launch.
//
// A field is a table [C, W] of 4-byte elements (f32 or int32),
// row-contiguous, and its output [N, W]. `sub`, when given, is an f32 row of
// S entries, S dividing W, entry j / (W / S) subtracted from column j of
// every gathered row (S = W: a row; the rebase's shift, S = 3, over the
// three planes of P points); without it the copy is of bits, whatever the
// element type.
//
// Design: the output write is the unit of work. A block takes a tile of T
// rows (T a multiple of 4, about 4,096 output elements over all fields) and
// loads the tile's slots (-1 where out of range) and every field's sub,
// expanded to its W columns, into shared memory once. Each field's part of
// the tile is contiguous in its output and 16-byte aligned; the parts'
// 16-byte chunks (4 elements, which may belong to two rows, or to four at
// W = 1) are numbered one after another, and each thread loads two chunks,
// of whatever fields, before it stores them (two, not four: 32 registers, so
// eight blocks an SM). A chunk's row and column come
// from a multiply by a reciprocal of W (no division). Source elements are
// read only for rows with a slot: 16-byte loads where W % 4 == 0 and the
// table is 16-byte aligned, 8-byte loads where W is even and the table
// 8-byte aligned, else 4-byte loads; an empty row costs only its stores.
// Bound: bytes, each distinct row read once, the slots, every output
// element written once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// measurement variants (tools/exp_rebase.py; the main build takes the
// defaults): the output elements a tile, the chunks a thread loads before
// storing
#ifndef K6_TILE
#define K6_TILE 4096
#endif
#ifndef K6_UNROLL
#define K6_UNROLL 2
#endif

constexpr int kThreads = 256;
constexpr int kMaxFields = 4;
constexpr int kMaxTile = 1024;       // rows a tile
constexpr int kMaxSubW = 1024;       // columns of every field with sub
constexpr int kTileElems = K6_TILE;  // output elements a tile, all fields
constexpr int kUnroll = K6_UNROLL;   // chunks a thread loads before storing

struct Field {
  const uint32_t* table;
  const float* sub;          // null: a copy of bits
  uint32_t* out;
  unsigned long long recip;  // ceil(2^32 / w): row = (e * recip) >> 32
  int w;
  int sub_rep;               // columns per sub entry (W / S)
  int sub_at;                // the first of its W columns in sub_sh
  int vec;                   // elements a source load: 4, 2 or 1
};

struct Fields {
  Field f[kMaxFields];
  int n;
};

// The 4 source elements of output elements e0 .. e0 + 3 of field f's tile
// part (e0 % 4 == 0; `total` elements in the part), minus sub, 0 for a row
// without a slot or past the part.
__device__ __forceinline__ uint4 load_chunk(const Field& f, const int* slot,
                                            const float* sub_sh, uint32_t e0,
                                            uint32_t total) {
  const uint32_t w = static_cast<uint32_t>(f.w);
  uint32_t r = static_cast<uint32_t>((e0 * f.recip) >> 32);
  uint32_t col = e0 - r * w;
  int sj[4];                 // each element's slot (-1: none) and column
  uint32_t cj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j > 0 && ++col == w) {
      col = 0;
      ++r;
    }
    cj[j] = col;
    sj[j] = e0 + j < total ? slot[r] : -1;
  }
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (f.vec == 4) {          // w % 4 == 0: one row, one 16-byte load
    if (sj[0] >= 0) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(
          f.table + static_cast<size_t>(sj[0]) * w + cj[0]));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    }
  } else if (f.vec == 2) {   // w even: two pairs, each in one row
#pragma unroll
    for (int h = 0; h < 4; h += 2) {
      if (sj[h] >= 0) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(
            f.table + static_cast<size_t>(sj[h]) * w + cj[h]));
        v[h] = x.x;
        v[h + 1] = x.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (sj[j] >= 0)
        v[j] = __ldg(f.table + static_cast<size_t>(sj[j]) * w + cj[j]);
  }
  if (f.sub != nullptr) {
    const float* sub = sub_sh + f.sub_at;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (sj[j] >= 0)
        v[j] = __float_as_uint(__uint_as_float(v[j]) - sub[cj[j]]);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(Fields fs, const int32_t* __restrict__ slots, int n,
                      int c, int tile) {
  __shared__ int slot[kMaxTile];
  __shared__ float sub_sh[kMaxSubW];
  const int row0 = blockIdx.x * tile;
  const int rows = min(tile, n - row0);
  for (int r = threadIdx.x; r < tile; r += kThreads) {
    const int s = r < rows ? slots[row0 + r] : -1;
    slot[r] = s >= 0 && s < c ? s : -1;
  }
  // each field's part of the tile: its elements and its first chunk; its
  // sub, expanded
  uint32_t total[kMaxFields], start[kMaxFields + 1];
  start[0] = 0;
#pragma unroll
  for (int f = 0; f < kMaxFields; ++f) {
    total[f] = f < fs.n ? static_cast<uint32_t>(rows) * fs.f[f].w : 0u;
    start[f + 1] = start[f] + (total[f] + 3) / 4;
    if (f < fs.n && fs.f[f].sub != nullptr)
      for (int j = threadIdx.x; j < fs.f[f].w; j += kThreads)
        sub_sh[fs.f[f].sub_at + j] =
            __ldg(fs.f[f].sub + j / fs.f[f].sub_rep);
  }
  __syncthreads();
  const uint32_t chunks = start[kMaxFields];
  for (uint32_t k0 = threadIdx.x; k0 < chunks; k0 += kUnroll * kThreads) {
    uint4 v[kUnroll];
    int fk[kUnroll];
    uint32_t lk[kUnroll];    // the chunk within its field's part
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t k = k0 + u * kThreads;
      int f = 0;
      uint32_t s0 = 0, tot = total[0];
#pragma unroll
      for (int g = 1; g < kMaxFields; ++g)
        if (k >= start[g]) {
          f = g;
          s0 = start[g];
          tot = total[g];
        }
      fk[u] = f;
      lk[u] = k - s0;
      if (k < chunks) v[u] = load_chunk(fs.f[f], slot, sub_sh, 4 * lk[u], tot);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t k = k0 + u * kThreads;
      if (k >= chunks) continue;
      const Field& f = fs.f[fk[u]];
      uint32_t* out = f.out + static_cast<size_t>(row0) * f.w + 4 * lk[u];
      const uint32_t left = static_cast<uint32_t>(rows) * f.w - 4 * lk[u];
      if (left >= 4) {
        *reinterpret_cast<uint4*>(out) = v[u];
      } else {               // the part's last, partial chunk
        const uint32_t x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        for (uint32_t j = 0; j < left; ++j) out[j] = x[j];
      }
    }
  }
}

}  // namespace

extern "C" int k6_max_fields() { return kMaxFields; }
extern "C" int k6_max_sub_width() { return kMaxSubW; }

// nf fields: tables[f] (4-byte elements [c, widths[f]]), subs[f] (f32
// [widths[f] / sub_reps[f]] or null; the fields with a sub at most
// k6_max_sub_width() columns together), outs[f] ([n, widths[f]], 16-byte
// aligned), vecs[f] (4, 2 or 1: the source loads, checked against the
// table's alignment by the caller); slots: int32 [n]. One launch.
extern "C" int k6_row_gather(int nf, void* const* tables, void* const* subs,
                             void* const* outs, const int* widths,
                             const int* sub_reps, const int* vecs,
                             const void* slots, int n, int c, void* stream) {
  if (nf < 1 || nf > kMaxFields)
    return static_cast<int>(cudaErrorInvalidValue);
  Fields fs{};
  fs.n = nf;
  int wsum = 0, sub_cols = 0;
  for (int i = 0; i < nf; ++i) {
    const int w = widths[i];
    if (w < 1) return static_cast<int>(cudaErrorInvalidValue);
    fs.f[i] = Field{static_cast<const uint32_t*>(tables[i]),
                    static_cast<const float*>(subs[i]),
                    static_cast<uint32_t*>(outs[i]),
                    ((1ull << 32) + w - 1) / w, w, sub_reps[i], sub_cols,
                    vecs[i]};
    if (subs[i] != nullptr) sub_cols += w;
    wsum += w;
  }
  if (sub_cols > kMaxSubW) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int tile = (kTileElems / wsum) & ~3;
  tile = tile < 4 ? 4 : (tile > kMaxTile ? kMaxTile : tile);
  const int blocks = (n + tile - 1) / tile;
  row_gather_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      fs, static_cast<const int32_t*>(slots), n, c, tile);
  return static_cast<int>(cudaGetLastError());
}
