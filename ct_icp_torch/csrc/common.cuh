// Shared device helpers of the ct_icp_torch kernels: voxel coordinates and
// the two 32-bit voxel hashes of ct_icp_tpu (ops/voxel.py,
// mapping/voxel_map.py::voxel_key_u32). Keys live in the table as uint32_t;
// 0 = EMPTY, 1 = TOMB.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace cticp {

constexpr uint32_t kEmpty = 0u;
constexpr uint32_t kTomb = 1u;
constexpr int kProbeWindow = 8;   // query-side probe window (PROBE_WINDOW)
constexpr int kMaxProbes = 16;    // insert claim rounds (MAX_PROBES)

// Truncation toward zero of an IEEE division (built without fast math, so
// x / v is a true division, never x * (1 / v)).
__device__ __forceinline__ int voxel_coord(float x, float v) {
  return static_cast<int>(truncf(x / v));
}

__device__ __forceinline__ uint32_t voxel_hash_u32(int cx, int cy, int cz) {
  return static_cast<uint32_t>(cx) * 73856093u +
         static_cast<uint32_t>(cy) * 19349669u +
         static_cast<uint32_t>(cz) * 83492791u;
}

__device__ __forceinline__ uint32_t voxel_key_u32(int cx, int cy, int cz) {
  uint32_t h = ((static_cast<uint32_t>(cx) * 2654435761u) ^
                (static_cast<uint32_t>(cy) * 2246822519u)) +
               static_cast<uint32_t>(cz) * 3266489917u;
  return h < 2u ? h + 2u : h;
}

}  // namespace cticp
