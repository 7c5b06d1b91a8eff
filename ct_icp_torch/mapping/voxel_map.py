"""The voxel hash map as fixed-shape device tensors (main-path subset).

Counterpart of ``ct_icp_tpu/mapping/voxel_map.py``; the layout is the same:

    keys       int32[C]    slot occupancy: 0 = EMPTY, 1 = TOMB, else the
                           uint32 identity key of the voxel (ops/voxel.py
                           voxel_key_u32), stored as its int32 bit pattern
    count      int32[C]
    points     f32[C, 3P]  PLANAR rows: x-plane | y-plane | z-plane
    normals    f32[C, 3]   per-voxel normal (not maintained on this path)
    nflags     int32[C]
    num_points int32[1]

The reference's rolled [C, 2R] probe window (``win``) is TPU layout and is
dropped: the lookup kernel probes ``keys`` directly.

Unlike the reference, insert and prune update the level in place (the map is
~100 MB at driving capacity and a frame rewrites a few rows of it).
"""

from typing import NamedTuple, Tuple

import torch

from ct_icp_torch.kernels import candidate_gather as k1
from ct_icp_torch.kernels import map_insert as k3
from ct_icp_torch.kernels import plane_moments as k2

EMPTY = k3.EMPTY
TOMB = k3.TOMB
MAX_PROBES = k3.MAX_PROBES
PROBE_WINDOW = k3.PROBE_WINDOW


class MapLevel(NamedTuple):
    keys: torch.Tensor
    count: torch.Tensor
    points: torch.Tensor
    normals: torch.Tensor
    nflags: torch.Tensor
    num_points: torch.Tensor

    @property
    def capacity(self):
        return self.keys.shape[0]

    @property
    def max_points(self):
        return self.points.shape[1] // 3


MapState = Tuple[MapLevel, ...]


def make_level(capacity_log2: int, max_points: int, device) -> MapLevel:
    c = 1 << capacity_log2
    i32 = dict(dtype=torch.int32, device=device)
    return MapLevel(
        keys=torch.zeros((c,), **i32),
        count=torch.zeros((c,), **i32),
        points=torch.zeros((c, max_points * 3), dtype=torch.float32,
                           device=device),
        normals=torch.zeros((c, 3), dtype=torch.float32, device=device),
        nflags=torch.zeros((c,), **i32),
        num_points=torch.zeros((1,), **i32))


def make_map(options, device) -> MapState:
    return tuple(make_level(r.capacity_log2, r.max_num_points, device)
                 for r in options.resolutions)


def find_slots_with_count(level: MapLevel, query_coords):
    """Voxel coords [..., 3] -> (slot [...], count [...]); slot -1 where the
    voxel is absent (count 0 there)."""
    return k1.find_slots_with_count(level.keys, level.count, query_coords)


def gather_candidate_planes(level: MapLevel, queries, query_valid,
                            resolution: float, nv: int,
                            threshold_voxel_occupancy: int = 1):
    """Search front-end (kernel K1): candidate rows [M, O, 3P] of the
    (2nv+1)^3 voxels around each query + their usable counts [M, O]."""
    return k1.candidate_gather(level.keys, level.count, level.points, queries,
                               query_valid, resolution, nv,
                               threshold_voxel_occupancy)


def moments_from_planes(rows, cnt_ok, queries, radius: float,
                        k_nearest=None, cached_r_eff2=None) -> k2.Moments:
    """Scoring half (kernel K2): in-radius moments of cached candidate rows
    vs the current query positions, the closest candidate and the
    descriptor (normal, a2D) — see kernels/plane_moments.py."""
    return k2.plane_moments(rows, cnt_ok, queries, radius, k_nearest,
                            cached_r_eff2)


def insert_points(level: MapLevel, pts, valid, resolution: float,
                  min_dist: float, max_rounds: int = 4):
    """Insert a point batch into the level in place (kernel K3; the
    reference's ``with_normals=False`` path). Returns int32[1] inserted."""
    return k3.map_insert(level.keys, level.count, level.points,
                         level.num_points, pts, valid, resolution, min_dist,
                         max_rounds)


def prune_level(level: MapLevel, location, max_distance: float, gate=None):
    """Tombstone, in place, every voxel whose first point lies farther than
    ``max_distance`` from ``location`` (reference
    RemoveElementsFarFromLocation, map.h:305-322); only where the bool
    tensor ``gate`` holds, when given. Probe chains stay intact."""
    p = level.max_points
    occupied = (level.keys != EMPTY) & (level.keys != TOMB)
    dx = level.points[:, 0] - location[0]
    dy = level.points[:, p] - location[1]
    dz = level.points[:, 2 * p] - location[2]
    d2 = dx * dx + dy * dy + dz * dz
    drop = occupied & (d2 > float(max_distance) * float(max_distance))
    if gate is not None:
        drop = drop & gate
    zero = torch.zeros_like(level.count)
    level.num_points.sub_(
        torch.where(drop, level.count, zero).sum().to(torch.int32))
    level.keys.copy_(torch.where(drop, torch.full_like(level.keys, TOMB),
                                 level.keys))
    level.count.copy_(torch.where(drop, zero, level.count))
    level.nflags.copy_(torch.where(drop, zero, level.nflags))
