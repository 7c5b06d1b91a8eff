// K10 level_normals: the map export's normal refit of the listed voxels.
//
// Replaces ct_icp_tpu/mapping/voxel_map.py::_voxel_plane_fit (:524-546) and
// ::recompute_level_normals (:549-561): of the listed slots, every slot
// whose key is a voxel's (not EMPTY or TOMB) and which holds at least 5
// points gets a plane fit from the moments of its points about its first
// point (description_from_moments, the eigensolve of csrc/eigh3.cuh shared
// with K2), its normal flipped where (barycenter - location) . normal > 0,
// and its flag set to 2; every other listed slot keeps its normal and flag.
// The results go into NEW tensors, a row for each listed slot: the
// reference refits a copy of the level for the export
// (odometry.py:1268-1274) and leaves the map's own normals alone, and so
// does the port. The export lists the occupied slots it copies out
// (Odometry.get_map_points), so the slots it does not export are not read.
//
// One launch over the S listed slots, a warp for each: the warp reads the
// slot's index, key and count; a slot not refit has its normal and flag
// copied through by lane 0; for a refit slot the warp reads its P planar
// points (lane l takes points l and l + 32), forms the nine moments about
// point 0 and sums them by shuffles, and lane 0 runs the eigensolve and
// the orientation. A warp a slot, not a lane a slot: the export lists the
// occupied slots compacted, so a level where most of them are refit would
// otherwise run 32 refits one after another on each warp.
//
// Bound: bytes. Each listed slot's index, key and count read and its
// normal and flag written (28 B), the normal and flag of each listed slot
// not refit read (16 B), and the live points of each refit slot read (12 B
// a point); a few hundred operations a refit slot. Float sums are taken in
// another order than the plain version's, so normals differ in the last
// bits; the set of refit slots and the flags come from integer compares
// and are exact.
#include "common.cuh"
#include "eigh3.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinPoints = 5;
constexpr int kRefitFlag = 2;

__global__ void __launch_bounds__(kThreads) level_normals_kernel(
    const uint32_t* __restrict__ keys, const int32_t* __restrict__ count,
    const float* __restrict__ points, const float* __restrict__ normals,
    const int32_t* __restrict__ nflags, const float* __restrict__ location,
    const int32_t* __restrict__ slots, int n_slots, int p,
    float* __restrict__ out_normals, int32_t* __restrict__ out_nflags) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_slots) return;  // whole warp
  const int slot = slots[i];
  const uint32_t key = keys[slot];
  const int cnt = count[slot];
  if (key <= cticp::kTomb || cnt < kMinPoints) {
    if (lane == 0) {
      out_normals[3 * i + 0] = normals[3 * slot + 0];
      out_normals[3 * i + 1] = normals[3 * slot + 1];
      out_normals[3 * i + 2] = normals[3 * slot + 2];
      out_nflags[i] = nflags[slot];
    }
    return;  // whole warp
  }

  // the nine moments about the first point: x, y, z, xx, xy, xz, yy, yz, zz
  const int n = min(cnt, p);
  const float* row = points + static_cast<size_t>(slot) * (3 * p);
  const float ox = row[0], oy = row[p], oz = row[2 * p];
  float m[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const float rx = row[j] - ox;
    const float ry = row[p + j] - oy;
    const float rz = row[2 * p + j] - oz;
    m[0] += rx;
    m[1] += ry;
    m[2] += rz;
    m[3] += rx * rx;
    m[4] += rx * ry;
    m[5] += rx * rz;
    m[6] += ry * ry;
    m[7] += ry * rz;
    m[8] += rz * rz;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      m[k] += __shfl_xor_sync(0xffffffffu, m[k], sh);
  if (lane != 0) return;

  // description_from_moments, then the orientation toward location
  const float cs = fmaxf(static_cast<float>(n), 1.0f);
  const float mean[3] = {m[0] / cs, m[1] / cs, m[2] / cs};
  const float so[3][3] = {{m[3], m[4], m[5]},
                          {m[4], m[6], m[7]},
                          {m[5], m[7], m[8]}};
  float cov[3][3];
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) cov[a][c] = so[a][c] / cs - mean[a] * mean[c];
  const cticp::Eig eig = cticp::eigh3x3_normal(cov);
  const float dot = ((mean[0] + ox - location[0]) * eig.normal[0] +
                     (mean[1] + oy - location[1]) * eig.normal[1]) +
                    (mean[2] + oz - location[2]) * eig.normal[2];
  const float sign = dot > 0.0f ? -1.0f : 1.0f;
  out_normals[3 * i + 0] = sign * eig.normal[0];
  out_normals[3 * i + 1] = sign * eig.normal[1];
  out_normals[3 * i + 2] = sign * eig.normal[2];
  out_nflags[i] = kRefitFlag;
}

}  // namespace

// keys / count / nflags int32[C], points f32[C, 3P] (planar rows),
// normals f32[C, 3], location f32[3], slots int32[S] (each in [0, C));
// out_normals f32[S, 3] and out_nflags int32[S] are written in full.
extern "C" int k10_level_normals(const void* keys, const void* count,
                                 const void* points, const void* normals,
                                 const void* nflags, const void* location,
                                 const void* slots, int n_slots, int p,
                                 void* out_normals, void* out_nflags,
                                 void* stream) {
  if (n_slots > 0) {
    const int blocks = (n_slots + kWarps - 1) / kWarps;
    level_normals_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(count),
        static_cast<const float*>(points), static_cast<const float*>(normals),
        static_cast<const int32_t*>(nflags),
        static_cast<const float*>(location),
        static_cast<const int32_t*>(slots), n_slots, p,
        static_cast<float*>(out_normals), static_cast<int32_t*>(out_nflags));
  }
  return static_cast<int>(cudaGetLastError());
}
