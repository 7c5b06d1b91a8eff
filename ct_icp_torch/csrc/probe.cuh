// The voxel-map lookup shared by K1 candidate_gather and K9 evict_voxels:
// the device half of ct_icp_tpu/mapping/voxel_map.py::find_slots (:168-193).
// A voxel's slot is the first key match among the PROBE_WINDOW slots from
// hash & (C-1), before the first EMPTY; -1 where there is none.
#pragma once
#include "common.cuh"

namespace cticp {

// Key p of the probe window held in w (the aligned 16-byte chunks from the
// window's first slot, which lies at w[shift]).
__device__ __forceinline__ uint32_t window_key(const uint32_t (&w)[12],
                                               uint32_t shift, int p) {
  return shift == 0u ? w[p] : shift == 1u ? w[p + 1]
                              : shift == 2u ? w[p + 2] : w[p + 3];
}

// The slot of voxel (cx, cy, cz), or -1 where it is absent. The window's 8
// keys lie in the three aligned 16-byte chunks from (h & (C-1)) & ~3 (C is
// a power of two >= 8 and keys is 16-byte aligned, so no chunk wraps). The
// first chunk settles most probes (a sparse table: its first key is the
// voxel's or EMPTY); the other two are loaded only where it does not. The
// keys are read through the read-only cache: no caller writes them.
__device__ __forceinline__ int probe_slot(const uint32_t* __restrict__ keys,
                                          uint32_t cap_mask, int cx, int cy,
                                          int cz) {
  const uint32_t h = voxel_hash_u32(cx, cy, cz);
  const uint32_t k2 = voxel_key_u32(cx, cy, cz);
  const uint32_t at = h & cap_mask;
  const uint32_t shift = at & 3u;
  const uint4* chunks = reinterpret_cast<const uint4*>(keys);
  uint32_t w[12];
  int found = -1;
  bool stop = false;
  auto look = [&](int p) {
    const uint32_t key = window_key(w, shift, p);
    if (!stop && key == kEmpty) stop = true;
    if (!stop && key == k2) {
      found = p;
      stop = true;
    }
  };
  auto load = [&](int c) {
    const uint4 v = __ldg(chunks + ((((at & ~3u) + 4u * c) & cap_mask) >> 2));
    w[4 * c + 0] = v.x;
    w[4 * c + 1] = v.y;
    w[4 * c + 2] = v.z;
    w[4 * c + 3] = v.w;
  };
  load(0);
#pragma unroll
  for (int p = 0; p < 4; ++p)
    if (static_cast<uint32_t>(p) + shift < 4u) look(p);
  if (!stop) {
    load(1);
    load(2);
#pragma unroll
    for (int p = 1; p < kProbeWindow; ++p)
      if (static_cast<uint32_t>(p) + shift >= 4u) look(p);
  }
  if (found < 0) return -1;
  return static_cast<int>((at + static_cast<uint32_t>(found)) & cap_mask);
}

}  // namespace cticp
