// K12 knn_search: the bounded exact k-NN search of the map.
//
// Replaces ct_icp_tpu/mapping/voxel_map.py::radius_search (:917-937) over
// ::_candidate_planes (:821-842), the reference C++'s bounded priority queue
// (map.h:449-514): for each query, the k nearest live candidates with
// d2 <= radius^2, sorted by d2, ties to the lower flat index o * P + j (the
// order of jax.lax.top_k on -d2). The candidates are K1's over all O voxels:
// point j of candidate o is live for j < cnt_ok[q, o] and is read from the
// map at points[slots[q, o]][j], [P + j] and [2P + j]; the reference
// gathered an [M, O, 3P] copy of the rows first.
//
// The order is one 64-bit key a candidate, (bits of d2) << 32 | o * P + j:
// d2 >= 0, so its bits order as the float does, and the index breaks ties.
// It is the key the plain version hands to torch.topk. The keys of a query
// are distinct, so any exact selection gives the plain version's list, in
// whatever order the candidates are met. kSplit warps a query (K12_SPLIT,
// 2 on the main path):
//   1. it loads the query's O (slot, cnt_ok) pairs into shared memory and
//      exclusive-scans the counts into live offsets (as K2 does);
//   2. lane l takes live candidates l, l + 32, l + 64, ... (a cursor steps
//      over the offsets to (o, j)), so a batch is 32 consecutive live
//      candidates (with kSplit warps, warp w takes every kSplit-th batch);
//   3. each warp keeps its best keys in registers, one sorted array of
//      L = 32 R keys (R = 1, 2 or 4 a lane: L >= k), element e in register
//      e / 32 of lane e % 32, empty entries all ones. A candidate outside
//      the radius, or not below the k-th kept key, becomes all ones; a
//      batch with none left is skipped on one ballot. Otherwise the batch is
//      sorted descending by a bitonic network over __shfl_xor_sync (15
//      compare-exchanges, sort32_desc), and merged into the array as a
//      bitonic merge does (merge_batch): the array's last 32 keys take the
//      minimum against the batch, which leaves the L smallest of both as
//      one bitonic sequence, and log2 L half-cleaners sort it (the strides
//      of 32 and more within a lane, the others across lanes). This is the
//      warp select of Johnson, Douze and Jegou, "Billion-scale similarity
//      search with GPUs" (2017), section 5, with a batch of one key a lane:
//      no candidate is inserted on its own. A query's whole candidate set
//      is never held: at O = 343 (the distance strategy's nv = 3) a query
//      may have 10,290 candidates;
//   4. with kSplit > 1 the other warps of the query hand their arrays to
//      its first warp through shared memory, which merges them the same way
//      (min against the reversed array, then the half-cleaners);
//   5. the list out: the first k keys, the points re-read through the
//      slots, sqrt(d2), and the mask; past the list, zeros, +inf and false.
//   6. (K17, the descriptor instance, kDesc > 0) the query's masked
//      moments over its list: each lane sums the offsets p - q and their
//      six products over the entries it wrote, the warp reduces them by
//      shuffles, and lane 0 runs the descriptor of
//      ops/neighborhood.py::compute_description on them (the covariance
//      sec / n - mean mean^T, csrc/eigh3.cuh's closed-form eigensolve, the
//      normal and a2D; kDesc = 2, the full descriptor, also the line,
//      linearity, planarity, barycenter and covariance that the ROBUST
//      solver and the line and distribution distances read). It replaces
//      ct_icp_tpu/ops/neighborhood.py::compute_description (:39), which the
//      reference runs on radius_search's list (icp/solver.py:280), and the
//      ~15 torch operations of its plain version an ICP iteration. The
//      sums are taken in another order than torch's, so the descriptor is
//      held to K2's tolerance (kernels/checks.py); steps 1-5 are the same
//      code in both instances, so the list is the plain version's bit for
//      bit in both.
// d2 is dx*dx + dy*dy + dz*dz left to right, in round-to-nearest intrinsics
// (and the file is built with -fmad=false), so the in-radius test and the
// order are the plain version's bit for bit.
//
// Bound: bytes. Each distinct live candidate point read once (12 B), the
// (slot, cnt_ok) pairs (8 B), the queries and radii, the outputs (17 B a
// neighbour). What holds the kernel above it is the selection's dependent
// chain a query (the network's shuffles, a batch after another): a merged
// batch costs the batch's 15 compare-exchanges and the merge's log2 L
// (5 of them shuffles), where inserting one candidate at a time cost a warp
// count, five shuffles and two warp barriers a candidate. Batches that beat
// nothing cost their d2 and one ballot.
#include "common.cuh"
#include "eigh3.cuh"

// Warps a query: 2 (tools/exp_select.py times 1, 2 and 4 on the main
// path's shapes; two warps were the fastest at O = 27 and at O = 343).
#ifndef K12_SPLIT
#define K12_SPLIT 2
#endif

namespace {

using Key = unsigned long long;

constexpr int kWarpsPerBlock = 4;
constexpr int kSplit = K12_SPLIT;                // warps a query
static_assert(kSplit == 1 || kSplit == 2 || kSplit == 4,
              "K12_SPLIT is 1, 2 or 4");
constexpr int kQueriesPerBlock = kWarpsPerBlock / kSplit;
constexpr int kMaxK = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr Key kNone = ~0ull;                     // an empty entry
constexpr uint32_t kInfBits = 0x7f800000u;       // +inf's bits

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float x,
                                       float y, float z) {
  const float dx = __fsub_rn(x, qx);
  const float dy = __fsub_rn(y, qy);
  const float dz = __fsub_rn(z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ Key kmin(Key a, Key b) { return a < b ? a : b; }
__device__ __forceinline__ Key kmax(Key a, Key b) { return a < b ? b : a; }

// The 32 keys of a warp, one a lane, sorted descending (lane 0 the
// largest): a bitonic sort. Stage `size` merges pairs of blocks of size / 2
// sorted in opposite directions into blocks of `size`, ascending where
// lane & size is set (the last stage, size 32, descending everywhere); the
// lower lane of a pair keeps the smaller key where its block ascends.
__device__ __forceinline__ Key sort32_desc(Key b, int lane) {
#pragma unroll
  for (int stage = 1; stage <= 5; ++stage) {       // size = 2^stage
    const bool up = (lane & (1 << stage)) != 0;
#pragma unroll
    for (int step = stage - 1; step >= 0; --step) {  // stride s = 2^step
      const int s = 1 << step;
      const Key o = __shfl_xor_sync(kFull, b, s);
      b = (((lane & s) == 0) == up) ? kmin(b, o) : kmax(b, o);
    }
  }
  return b;
}

// The L = 32 R keys of a, a bitonic sequence (element e in a[e / 32] of
// lane e % 32), sorted ascending by half-cleaners of strides L / 2 .. 1:
// within a lane for strides of 32 and more, across lanes below.
template <int R>
__device__ __forceinline__ void bitonic_to_ascending(Key (&a)[R], int lane) {
  constexpr int kLogR = R == 4 ? 2 : R == 2 ? 1 : 0;
#pragma unroll
  for (int step = kLogR - 1; step >= 0; --step) {   // stride 32 * 2^step
    const int rs = 1 << step;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((r & rs) == 0) {
        const Key lo = kmin(a[r], a[r + rs]);
        a[r + rs] = kmax(a[r], a[r + rs]);
        a[r] = lo;
      }
    }
  }
#pragma unroll
  for (int step = 4; step >= 0; --step) {            // stride 2^step
    const int s = 1 << step;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const Key o = __shfl_xor_sync(kFull, a[r], s);
      a[r] = (lane & s) == 0 ? kmin(a[r], o) : kmax(a[r], o);
    }
  }
}

// a (ascending) becomes the L smallest of a and a batch sorted descending
// (b_desc, one key a lane), ascending: the batch padded with all ones to L
// and reversed meets a element by element, so only the last register takes
// the minimum; the result is bitonic.
template <int R>
__device__ __forceinline__ void merge_batch(Key (&a)[R], Key b_desc,
                                            int lane) {
  a[R - 1] = kmin(a[R - 1], b_desc);
  bitonic_to_ascending<R>(a, lane);
}

// the k-th smallest kept key (element k - 1), in every lane.
// k12_knn_search takes the least R of 1, 2 and 4 with 32 R >= k, so
// element k - 1 lies in the last register, or at R = 4 in one of the last
// two: registers named, where one picked by index would put the array in
// local memory.
template <int R>
__device__ __forceinline__ Key kth_key(const Key (&a)[R], int k) {
  Key v = a[R - 1];
  if (R == 4 && k <= 96) v = a[R - 2];
  return __shfl_sync(kFull, v, (k - 1) & 31);
}

// the descriptor's outputs (K17; unused by the plain instance): normal
// f32[M, 3], a2d f32[M]; with the full descriptor also line f32[M, 3],
// linearity and planarity f32[M], barycenter f32[M, 3], covariance
// f32[M, 3, 3]
struct DescOut {
  float* normal;
  float* a2d;
  float* line;
  float* linearity;
  float* planarity;
  float* barycenter;
  float* covariance;
};

// ops/neighborhood.py::compute_description on the summed moments of n
// neighbours (offsets from the query q): lane 0 of the query's warp
template <int kDesc>
__device__ __forceinline__ void describe(const DescOut& d, int qi,
                                         const float* q, int n,
                                         const float* s, const float* so) {
  const float cs = fmaxf(static_cast<float>(n), 1.0f);
  float mean[3], cov[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) mean[a] = s[a] / cs;
  // so: xx, xy, xz, yy, yz, zz
  constexpr int kAt[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      cov[a][b] = so[kAt[a][b]] / cs - mean[a] * mean[b];
  float line[3];
  const cticp::Eig eig = cticp::eigh3x3_normal(cov, kDesc == 2 ? line
                                                               : nullptr);
  const float s0 = fmaxf(fabsf(eig.vals[0]), 1e-20f);
  const float s1 = fabsf(eig.vals[1]), s2 = fabsf(eig.vals[2]);
  for (int a = 0; a < 3; ++a) d.normal[3 * qi + a] = eig.normal[a];
  d.a2d[qi] = (sqrtf(s1) - sqrtf(s2)) / sqrtf(s0);
  if constexpr (kDesc == 2) {
    d.linearity[qi] = (fabsf(eig.vals[0]) - s1) / s0;
    d.planarity[qi] = (s1 - s2) / s0;
    for (int a = 0; a < 3; ++a) {
      d.line[3 * qi + a] = line[a];
      d.barycenter[3 * qi + a] = mean[a] + q[a];
      for (int b = 0; b < 3; ++b)
        d.covariance[9 * qi + 3 * a + b] = cov[a][b];
    }
  }
}

template <int R, int kDesc>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) knn_search_kernel(
    const float* __restrict__ points, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ cnt_ok, const float* __restrict__ queries,
    int m, int n_off, int p, float rr, const float* __restrict__ radius,
    int k, int group_bytes, float* __restrict__ out_pts,
    uint8_t* __restrict__ out_mask, float* __restrict__ out_dist,
    const DescOut desc) {
  constexpr int kL = 32 * R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = warp % kSplit;                   // the warp's rank a query
  const int qi = blockIdx.x * kQueriesPerBlock + warp / kSplit;
  const bool live_query = qi < m;                // warp-uniform
  if (kSplit == 1 && !live_query) return;        // no block barrier below
  unsigned char* base = smem + (warp / kSplit) * group_bytes;
  Key* handed = reinterpret_cast<Key*>(base);    // [(kSplit - 1) * kL]
  int* off = reinterpret_cast<int*>(handed + (kSplit - 1) * kL);  // [O + 1]
  int* slot = off + n_off + 1;                                    // [O]

  // ---- 1. the pairs, and the live offsets (the query's first warp)
  if (live_query && w == 0) {
    const int32_t* q_slots = slots + static_cast<size_t>(qi) * n_off;
    const int32_t* q_cnt = cnt_ok + static_cast<size_t>(qi) * n_off;
    for (int o = lane; o < n_off; o += 32) {
      slot[o] = q_slots[o];
      off[o] = q_cnt[o];
    }
    __syncwarp();
    int total = 0;
    for (int b = 0; b < n_off; b += 32) {
      const int o = b + lane;
      const int c = o < n_off ? off[o] : 0;
      int incl = c;
      for (int s = 1; s < 32; s <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl += up;
      }
      if (o < n_off) off[o] = total + incl - c;
      total += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) off[n_off] = total;
  }
  if (kSplit == 1)
    __syncwarp();
  else
    __syncthreads();

  Key a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = kNone;
  if (live_query) {
    const float qx = queries[3 * qi + 0];
    const float qy = queries[3 * qi + 1];
    const float qz = queries[3 * qi + 2];
    const float r2 =
        radius != nullptr ? __fmul_rn(radius[qi], radius[qi]) : rr;
    const int total = off[n_off];

    // ---- 2, 3. batches of 32 live candidates merged into the array
    Key kth = kNone;     // the k-th kept key (warp-uniform)
    int o = 0;           // the lane's cursor
    for (int b = 32 * w; b < total; b += 32 * kSplit) {
      const int i = b + lane;
      Key key = kNone;
      if (i < total) {
        while (off[o + 1] <= i) ++o;
        const int j = i - off[o];
        const float* row = points + static_cast<size_t>(slot[o]) * (3 * p);
        const float d2 = dist2(qx, qy, qz, row[j], row[p + j], row[2 * p + j]);
        if (d2 <= r2)
          key = (static_cast<Key>(__float_as_uint(d2)) << 32) |
                static_cast<uint32_t>(o * p + j);
      }
      if (key >= kth) key = kNone;
      if (__ballot_sync(kFull, key != kNone) == 0) continue;
      merge_batch<R>(a, sort32_desc(key, lane), lane);
      kth = kth_key<R>(a, k);
    }
  }

  // ---- 4. the query's other warps hand their arrays to its first
  if (kSplit > 1) {
    if (live_query && w > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) handed[(w - 1) * kL + r * 32 + lane] = a[r];
    }
    __syncthreads();
    if (!live_query || w > 0) return;
    for (int h = 0; h < kSplit - 1; ++h) {
      // element e meets element L - 1 - e of the other ascending array
#pragma unroll
      for (int r = 0; r < R; ++r)
        a[r] = kmin(a[r], handed[h * kL + kL - 1 - (r * 32 + lane)]);
      bitonic_to_ascending<R>(a, lane);
    }
  }

  // ---- 5. the list out; 6. with the descriptor, the lane's moments
  float q[3], mom[10];   // 6: the query; n, s x y z, xx xy xz yy yz zz
  if constexpr (kDesc > 0) {
    for (int c = 0; c < 3; ++c) q[c] = queries[3 * qi + c];
    for (int c = 0; c < 10; ++c) mom[c] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = r * 32 + lane;
    if (t >= k) continue;
    const size_t at = static_cast<size_t>(qi) * k + t;
    float* dst = out_pts + 3 * at;
    const uint32_t bits = static_cast<uint32_t>(a[r] >> 32);
    if (bits < kInfBits) {
      const int f = static_cast<int>(static_cast<uint32_t>(a[r]));
      const int oo = f / p;
      const int j = f - oo * p;
      const float* row = points + static_cast<size_t>(slot[oo]) * (3 * p);
      const float x = row[j], y = row[p + j], z = row[2 * p + j];
      dst[0] = x;
      dst[1] = y;
      dst[2] = z;
      out_mask[at] = 1;
      out_dist[at] = __fsqrt_rn(__uint_as_float(bits));
      if constexpr (kDesc > 0) {
        const float dx = __fsub_rn(x, q[0]);
        const float dy = __fsub_rn(y, q[1]);
        const float dz = __fsub_rn(z, q[2]);
        mom[0] += 1.0f;
        mom[1] += dx;
        mom[2] += dy;
        mom[3] += dz;
        mom[4] += __fmul_rn(dx, dx);
        mom[5] += __fmul_rn(dx, dy);
        mom[6] += __fmul_rn(dx, dz);
        mom[7] += __fmul_rn(dy, dy);
        mom[8] += __fmul_rn(dy, dz);
        mom[9] += __fmul_rn(dz, dz);
      }
    } else {
      dst[0] = dst[1] = dst[2] = 0.0f;
      out_mask[at] = 0;
      out_dist[at] = __uint_as_float(kInfBits);
    }
  }
  if constexpr (kDesc > 0) {
#pragma unroll
    for (int c = 0; c < 10; ++c)
      for (int o = 16; o > 0; o >>= 1)
        mom[c] += __shfl_xor_sync(kFull, mom[c], o);
    if (lane == 0)
      describe<kDesc>(desc, qi, q, static_cast<int>(mom[0]), mom + 1,
                      mom + 4);
  }
}

template <int R, int kDesc>
int launch(const void* points, const void* slots, const void* cnt_ok,
           const void* queries, int m, int n_off, int p, float rr,
           const void* radius, int k, void* out_pts, void* out_mask,
           void* out_dist, const DescOut& desc, cudaStream_t stream) {
  // a query's shared memory: the arrays its other warps hand over, then
  // the O + 1 offsets and O slots, rounded up to 8 bytes
  const int group_bytes =
      ((kSplit - 1) * 32 * R * 8 + (2 * n_off + 1) * 4 + 7) / 8 * 8;
  const int smem = group_bytes * kQueriesPerBlock;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_search_kernel<R, kDesc>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (m + kQueriesPerBlock - 1) / kQueriesPerBlock;
  knn_search_kernel<R, kDesc>
      <<<blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      static_cast<const float*>(points), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(cnt_ok),
      static_cast<const float*>(queries), m, n_off, p, rr,
      static_cast<const float*>(radius), k, group_bytes,
      static_cast<float*>(out_pts), static_cast<uint8_t*>(out_mask),
      static_cast<float*>(out_dist), desc);
  return static_cast<int>(cudaGetLastError());
}

// the least R of 1, 2 and 4 with 32 R >= k (kth_key relies on it)
template <int kDesc>
int launch_k(const void* points, const void* slots, const void* cnt_ok,
             const void* queries, int m, int n_off, int p, float rr,
             const void* radius, int k, void* out_pts, void* out_mask,
             void* out_dist, const DescOut& desc, cudaStream_t s) {
  if (k <= 32)
    return launch<1, kDesc>(points, slots, cnt_ok, queries, m, n_off, p, rr,
                            radius, k, out_pts, out_mask, out_dist, desc, s);
  if (k <= 64)
    return launch<2, kDesc>(points, slots, cnt_ok, queries, m, n_off, p, rr,
                            radius, k, out_pts, out_mask, out_dist, desc, s);
  return launch<4, kDesc>(points, slots, cnt_ok, queries, m, n_off, p, rr,
                          radius, k, out_pts, out_mask, out_dist, desc, s);
}

}  // namespace

// warps a query this library was built with (K12_SPLIT)
extern "C" int k12_split() { return kSplit; }

// points f32[C, 3P], slots / cnt_ok int32[M, O] (K1's output over all O
// voxels of the same level), queries f32[M, 3]; radius f32[M] (each query's
// radius, squared here) or NULL (then rr, the squared scalar radius);
// 1 <= k <= kMaxK. Outputs: f32[M, k, 3], bool[M, k], f32[M, k].
extern "C" int k12_knn_search(const void* points, const void* slots,
                              const void* cnt_ok, const void* queries, int m,
                              int n_off, int p, float rr, const void* radius,
                              int k, void* out_pts, void* out_mask,
                              void* out_dist, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  return launch_k<0>(points, slots, cnt_ok, queries, m, n_off, p, rr, radius,
                     k, out_pts, out_mask, out_dist, DescOut{},
                     static_cast<cudaStream_t>(stream));
}

// K17: k12_knn_search's list and outputs, and the descriptor of each
// query's list (ops/neighborhood.py::compute_description): normal f32[M, 3]
// and a2d f32[M]; with a non-NULL line, the full descriptor (line f32[M,
// 3], linearity and planarity f32[M], barycenter f32[M, 3], covariance
// f32[M, 3, 3]).
extern "C" int k17_knn_describe(const void* points, const void* slots,
                                const void* cnt_ok, const void* queries,
                                int m, int n_off, int p, float rr,
                                const void* radius, int k, void* out_pts,
                                void* out_mask, void* out_dist, void* normal,
                                void* a2d, void* line, void* linearity,
                                void* planarity, void* barycenter,
                                void* covariance, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const DescOut desc{static_cast<float*>(normal), static_cast<float*>(a2d),
                     static_cast<float*>(line), static_cast<float*>(linearity),
                     static_cast<float*>(planarity),
                     static_cast<float*>(barycenter),
                     static_cast<float*>(covariance)};
  auto* s = static_cast<cudaStream_t>(stream);
  if (line != nullptr)
    return launch_k<2>(points, slots, cnt_ok, queries, m, n_off, p, rr,
                       radius, k, out_pts, out_mask, out_dist, desc, s);
  return launch_k<1>(points, slots, cnt_ok, queries, m, n_off, p, rr, radius,
                     k, out_pts, out_mask, out_dist, desc, s);
}
