"""The voxel hash map as fixed-shape device tensors (main-path subset).

Counterpart of ``ct_icp_tpu/mapping/voxel_map.py``; the layout is the same:

    keys       int32[C]    slot occupancy: 0 = EMPTY, 1 = TOMB, else the
                           uint32 identity key of the voxel (ops/voxel.py
                           voxel_key_u32), stored as its int32 bit pattern
    count      int32[C]
    points     f32[C, 3P]  PLANAR rows: x-plane | y-plane | z-plane
    normals    f32[C, 3]   per-voxel normal (maintained by the insert only
                           when it is given the frame's begin location, as
                           the sharded map's is; the export refits them:
                           refit_normals)
    nflags     int32[C]
    num_points int32[1]

The reference's rolled [C, 2R] probe window (``win``) is TPU layout and is
dropped: the lookup kernel probes ``keys`` directly.

Unlike the reference, insert, prune and eviction update the level in place
(the map is ~100 MB at driving capacity and a frame rewrites a few rows of
it); the rebase (``rebuild_level``) and the export's normal refit
(``refit_normals``, ``recompute_level_normals``) return new tensors, as the
reference does.
"""

from typing import NamedTuple, Tuple

import torch

from ct_icp_torch.kernels import candidate_gather as k1
from ct_icp_torch.kernels import evict_voxels as k9
from ct_icp_torch.kernels import knn_search as k12
from ct_icp_torch.kernels import level_normals as k10
from ct_icp_torch.kernels import map_insert as k3
from ct_icp_torch.kernels import plane_moments as k2
from ct_icp_torch.kernels import rebuild as k7
from ct_icp_torch.kernels import row_gather as k6

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


def _filter_args(level: MapLevel, sensor_location, use_normal_filter):
    """K1's normal-filter arguments (normals, nflags, sensor) of a search:
    the filter is on when asked for and given a sensor location."""
    if use_normal_filter and sensor_location is not None:
        return dict(normals=level.normals, nflags=level.nflags,
                    sensor_location=sensor_location)
    return {}


def gather_candidate_planes(level: MapLevel, queries, query_valid,
                            resolution: float, nv: int,
                            threshold_voxel_occupancy: int = 1,
                            max_candidates: int = 0, sensor_location=None,
                            use_normal_filter: bool = False):
    """Search front-end (kernel K1): the slots [M, O] of the (2nv+1)^3
    voxels around each query (0 where absent) + their usable counts [M, O];
    with 0 < max_candidates < O, only the first max_candidates of them,
    usable and nearer voxels first. With ``use_normal_filter`` and a
    ``sensor_location`` (f32[3] on the level's device), a voxel whose normal
    is set and faces away from the sensor is not usable (reference
    :699-703).

    Departs from the reference, which returns the candidate rows
    ``level.points[slots]`` [M, O, 3P]: the TPU's DMA wants dense rows, so
    its cache holds a copy; on the card K2 reads the live points through
    the slots, and the level is not written between a gather and the
    rescorings that reuse it (icp/solver.py)."""
    return k1.candidate_gather(level.keys, level.count, queries, query_valid,
                               resolution, nv, threshold_voxel_occupancy,
                               max_candidates, **_filter_args(
                                   level, sensor_location, use_normal_filter))


def moments_from_planes(level: MapLevel, slots, cnt_ok, queries, radius,
                        k_nearest=None, cached_r_eff2=None) -> k2.Moments:
    """Scoring half (kernel K2): in-radius moments of the candidates that
    ``gather_candidate_planes`` found vs the current query positions, the
    closest candidate and the descriptor (normal, a2D) — see
    kernels/plane_moments.py. The reference scores its cached rows; this
    reads candidate o's points from ``level.points[slots[:, o]]``.
    ``radius`` is a float or f32[M] (a radius a query)."""
    return k2.plane_moments(level.points, slots, cnt_ok, queries, radius,
                            k_nearest, cached_r_eff2)


def ball_search_moments(level: MapLevel, queries, query_valid, radius,
                        resolution: float, nv: int, sensor_location=None,
                        use_normal_filter: bool = False,
                        threshold_voxel_occupancy: int = 1) -> k2.Moments:
    """Moments of every in-radius map point around each query (reference
    ``voxel_map.py:845-887`` with no k-NN cap): K1 over all (2nv+1)^3
    voxels, no compaction (with the normal filter when asked), then K2 with
    ``k_nearest=None``. ``radius`` is a float or f32[M].
    Returns K2's ``Moments``: the reference's (count, sum_rel, sum_outer,
    closest, closest_dist) and, beyond them, the descriptor (normal, a2D)
    its callers compute from the moments."""
    slots, cnt_ok = gather_candidate_planes(
        level, queries, query_valid, resolution, nv,
        threshold_voxel_occupancy, 0, sensor_location, use_normal_filter)
    return k2.plane_moments(level.points, slots, cnt_ok, queries, radius,
                            None)


def radius_search(level: MapLevel, queries, query_valid, radius,
                  resolution: float, nv: int, k: int, sensor_location=None,
                  use_normal_filter: bool = False,
                  threshold_voxel_occupancy: int = 1) -> k12.Neighbors:
    """Bounded k-nearest search (reference ``voxel_map.py:917-937``, the
    C++'s RadiusSearchInPlace, map.h:449-514): the k nearest in-radius map
    points of each query, sorted by distance. K1 over all (2nv+1)^3 voxels
    (the normal filter when asked), then K12. Returns ``Neighbors``
    (points f32[M, k, 3], mask bool[M, k], dist f32[M, k]); a masked-out
    entry holds zeros and inf, where the reference holds whatever its
    top_k picked. ``radius`` is a float or f32[M]."""
    slots, cnt_ok = gather_candidate_planes(
        level, queries, query_valid, resolution, nv,
        threshold_voxel_occupancy, 0, sensor_location, use_normal_filter)
    return k12.knn_search(level.points, slots, cnt_ok, queries, radius, k)


def ball_search(level: MapLevel, queries, query_valid, radius,
                resolution: float, nv: int, sensor_location=None,
                use_normal_filter: bool = False,
                threshold_voxel_occupancy: int = 1):
    """All candidates within ``radius`` in the reference's compat shape
    (``voxel_map.py:893-914``): (cand f32[M, O * P, 3], mask bool[M, O * P],
    closest f32[M, 3], closest_dist f32[M] (inf where none), count
    int32[M]). K1 over all voxels, then a materialising gather through its
    slots in plain torch: no hot path calls it, as the reference's own
    docstring says."""
    slots, cnt_ok = gather_candidate_planes(
        level, queries, query_valid, resolution, nv,
        threshold_voxel_occupancy, 0, sensor_location, use_normal_filter)
    m, o = cnt_ok.shape
    p = level.max_points
    rows = level.points[slots.long()].view(m, o, 3, p)
    cand = rows.permute(0, 1, 3, 2).reshape(m, o * p, 3)
    rel = cand - queries[:, None, :]
    d2 = (rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
          + rel[..., 2] * rel[..., 2])
    rr = k2.radius_sq(radius)
    live = (torch.arange(p, dtype=torch.int32, device=queries.device)
            [None, None, :] < cnt_ok[..., None]).reshape(m, o * p)
    mask = live & (d2 <= (rr[:, None] if torch.is_tensor(rr) else rr))
    d2m = torch.where(mask, d2, torch.full_like(d2, float("inf")))
    amin = torch.argmin(d2m, dim=1)
    closest = torch.gather(cand, 1, amin[:, None, None].expand(m, 1, 3))[:, 0]
    cd2 = torch.gather(d2m, 1, amin[:, None])[:, 0]
    count = mask.sum(-1, dtype=torch.int32)
    closest_dist = torch.where(count > 0, torch.sqrt(cd2),
                               torch.full_like(cd2, float("inf")))
    return cand, mask, closest, closest_dist, count


def insert_points(level: MapLevel, pts, valid, resolution: float,
                  min_dist: float, max_rounds: int = 4, begin_tr=None,
                  max_dirty=None):
    """Insert a point batch into the level in place (kernel K3). Returns
    int32[1] inserted.

    Without ``begin_tr`` it is the reference's ``with_normals=False`` path.
    With ``begin_tr`` (f32[3] on the level's device, the frame's begin
    location) it is the ``with_normals`` path (reference :474-510): the
    dirty voxels are the slots of the points accepted with election rank 0,
    in scan order, the first ``max_dirty`` of them (all when None); K10
    refits each one of at least 5 points, oriented toward ``begin_tr``, and
    its normal and flag 2 are written back. Listing the dirty slots reads
    their number back to the host (one sync)."""
    if begin_tr is None:
        return k3.map_insert(level.keys, level.count, level.points,
                             level.num_points, pts, valid, resolution,
                             min_dist, max_rounds)
    inserted, r0 = k3.map_insert(level.keys, level.count, level.points,
                                 level.num_points, pts, valid, resolution,
                                 min_dist, max_rounds, rank0=True)
    dirty = torch.nonzero(r0 >= 0)[:, 0]
    if max_dirty is not None:
        dirty = dirty[:max_dirty]
    slots = r0[dirty]
    if slots.numel():
        normals, nflags = refit_normals(level, begin_tr, slots)
        at = slots.long()
        level.normals[at] = normals
        level.nflags[at] = nflags
    return inserted


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


def evict_voxels(level: MapLevel, coords, valid):
    """Empty, in place, the voxels at ``coords`` int32[M, 3] where ``valid``
    holds (kernel K9): counts and flags drop to 0, keys stay claimed, so
    probe chains stay intact and a later insert of a voxel refills its
    slot (reference voxel_map.py:564-593, the backend replay's eviction).
    Returns the points removed, int32[1] on the device."""
    return k9.evict_voxels(level.keys, level.count, level.nflags,
                           level.num_points, coords, valid)


def evict_levels(levels, coords, counts):
    """:func:`evict_voxels` on every level at once (kernel K9, one launch):
    level l empties the voxels at the first ``counts[l]`` (host ints) rows
    of ``coords[l]`` int32[M_l, 3]. Returns int32[L + 1] on the device: the
    points removed from each level, then their total."""
    return k9.evict_levels(levels, coords, counts)


def occupied_slots(level: MapLevel):
    """int32[S]: the slots holding a voxel's key and points, in slot order
    (the map export's rows)."""
    occupied = ((level.keys != EMPTY) & (level.keys != TOMB)
                & (level.count > 0))
    return torch.nonzero(occupied)[:, 0].to(torch.int32)


def refit_normals(level: MapLevel, location, slots):
    """The normals and flags of the listed ``slots`` int32[S], those of
    every occupied voxel of >= 5 points refit and oriented toward
    ``location`` (f32[3] on the device), flag 2 (kernel K10; reference
    voxel_map.py:524-561, the map export's refresh): new tensors
    (f32[S, 3], int32[S]); the level is left as it is."""
    return k10.level_normals(level.keys, level.count, level.points,
                             level.normals, level.nflags, location, slots)


def recompute_level_normals(level: MapLevel, location) -> MapLevel:
    """The level with the normal of every occupied voxel of >= 5 points
    refit and oriented toward ``location`` (:func:`refit_normals` over
    every slot). The normals and flags are new tensors; the level itself
    is left as it is."""
    slots = torch.arange(level.capacity, dtype=torch.int32,
                         device=level.keys.device)
    normals, nflags = refit_normals(level, location, slots)
    return level._replace(normals=normals, nflags=nflags)


def rebuild_level(level: MapLevel, shift, resolution: float) -> MapLevel:
    """Rebase the level's frame: subtract ``shift`` (f32[3] on the level's
    device) from every stored point and rebuild the hash table from scratch
    (row-level rehash; clears tombstones). Returns a new level. K7 claims
    the fresh table, elects each slot's writer row and sums the writers'
    counts into num_points; K6, in one launch, moves the rows (the points
    with the shift subtracted from each plane, the normals, counts and
    flags as they are); empty slots come out zero. Two launches on the
    card. Rows whose first points land in one voxel after the shift share
    its slot and only the writer's row is kept (off the voxel grid, a good
    share of rows: the reference's docstring calls them rare); rows left
    unresolved after MAX_PROBES rounds are dropped too (reference
    voxel_map.py:619-657)."""
    table, src, num_points = k7.rebuild_claim(level.keys, level.count,
                                              level.points, shift, resolution)
    count, points, normals, nflags = k6.row_gather_fields(
        (level.count[:, None], level.points, level.normals,
         level.nflags[:, None]), src, (None, shift, None, None))
    return MapLevel(keys=table, count=count[:, 0], points=points,
                    normals=normals, nflags=nflags[:, 0],
                    num_points=num_points)
