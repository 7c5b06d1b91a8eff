"""The voxel map sharded over the ranks of a process group (A11).

Counterpart of ``ct_icp_tpu/parallel/sharded_map.py``. The reference holds
the shards as one array with a leading shard axis under ``shard_map``; here
each rank holds its own shard, a tuple of ``mapping.voxel_map.MapLevel``s,
on its own device, and the mesh's collectives are ``parallel/comm.py``'s.

  * each rank owns an open-addressed table of ``C / n`` slots (at least
    2^8); a voxel belongs to rank ``owner_hash(voxel) % n``
    (``kernels/owner_pack.py::owner_hash``, a second hash, decoupled from
    the slot probe hash so the shards fill evenly);
  * the broadcast insert: every rank prunes each level and inserts the
    points of the replicated scan whose voxels it owns;
  * the partitioned insert: rank r takes chunk r of the scan, packs it by
    owner (K11), exchanges it with one all_to_all per level for the points
    and one for their flags, and inserts what it received: the same
    points, in the same global scan order, as the broadcast insert gives
    it;
  * the ball query: every rank computes the moments of its own voxels
    around the replicated queries (K1 over all (2nv+1)^3 voxels, then K2),
    and one sum over the ranks combines them exactly
    (:func:`combine_moments`).

Both inserts keep the reference's ``with_normals`` insert: the dirty voxels
of each level are refit (K10) and oriented toward the frame's begin
location.
"""

from typing import NamedTuple, Tuple

import torch

from ct_icp_torch import resolve_device
from ct_icp_torch.kernels import owner_pack as k11
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.parallel import comm

owner_hash = k11.owner_hash


class ShardedMapState(NamedTuple):
    levels: Tuple[vm.MapLevel, ...]   # this rank's shard of each level


def shard_capacity_log2(capacity_log2: int, n: int) -> int:
    """The slots of a shard (log2) of a level of 2^capacity_log2 slots
    split over ``n`` ranks (reference :58)."""
    return max(capacity_log2 - (n - 1).bit_length(), 8)


def make_sharded_map(options, group=None, device=None) -> ShardedMapState:
    """This rank's empty shard of every level of ``options``
    (``MultiResolutionVoxelMapOptions``), on ``device`` (the card unless
    the caller asks for the CPU)."""
    n = comm.size(group)
    dev = resolve_device(device)
    return ShardedMapState(levels=tuple(
        vm.make_level(shard_capacity_log2(r.capacity_log2, n),
                      r.max_num_points, dev)
        for r in options.resolutions))


def _level_params(options):
    return (tuple(r.resolution for r in options.resolutions),
            tuple(r.min_distance_between_points for r in options.resolutions))


# the election rounds of an insert (voxel_map.insert_points' default, as
# the reference's sharded inserts take it)
MAX_ROUNDS = 4


def make_sharded_update_fn(options, max_dirty: int, group=None):
    """The broadcast insert (reference :67-107): update(state, world [M, 3],
    valid [M], begin_tr [3], location [3], max_distance) -> (state, the
    points inserted over every rank, int32[1]). Every rank receives the
    whole scan; the levels are updated in place."""
    n = comm.size(group)
    me = comm.rank(group)
    resolutions, min_dists = _level_params(options)

    def update(state: ShardedMapState, world, valid, begin_tr, location,
               max_distance: float):
        inserted = torch.zeros((1,), dtype=torch.int32, device=world.device)
        vm.prune_levels(state.levels, location, max_distance)
        for i, level in enumerate(state.levels):
            mine = valid & (k11.owners(world, resolutions[i], n) == me)
            inserted += vm.insert_points(level, world, mine, resolutions[i],
                                         min_dists[i], MAX_ROUNDS, begin_tr,
                                         max_dirty)
        return state, comm.sum_(inserted, group)

    return update


def pair_capacity(m: int, n: int, slack: float) -> int:
    """Points a (source, destination) pair may send, for chunks of ``m``
    points over ``n`` ranks (reference :146)."""
    return max(64, -(-int(m * slack) // n))


def make_partitioned_update_fn(options, max_dirty: int, group=None,
                               slack: float = 2.0):
    """The point-partitioned insert (reference :110-205): update(state,
    world [M, 3], valid [M], begin_tr, location, max_distance) -> (state,
    inserted int32[1], dropped int32[1]), both summed over the ranks. The
    scan is padded to a multiple of n and rank r takes chunk r; each level
    packs the chunk by owner (K11, ``pair_capacity`` points a pair; the
    rest dropped and counted), exchanges the send buffers with one
    all_to_all for the points and one for their flags, prunes and inserts
    the n * cap rows it received (sources in rank order: the global scan
    order)."""
    n = comm.size(group)
    me = comm.rank(group)
    resolutions, min_dists = _level_params(options)

    def update(state: ShardedMapState, world, valid, begin_tr, location,
               max_distance: float):
        m = world.shape[0]
        if m % n:
            pad = n - m % n
            world = torch.cat([world, world.new_zeros((pad, 3))])
            valid = torch.cat([valid, valid.new_zeros((pad,))])
        chunk = world.shape[0] // n
        w = world[me * chunk:(me + 1) * chunk].contiguous()
        v = valid[me * chunk:(me + 1) * chunk].contiguous()
        cap = pair_capacity(chunk, n, slack)
        dev = world.device
        inserted = torch.zeros((1,), dtype=torch.int32, device=dev)
        dropped = torch.zeros((1,), dtype=torch.int32, device=dev)
        vm.prune_levels(state.levels, location, max_distance)
        for i, level in enumerate(state.levels):
            packed = k11.owner_pack(w, v, resolutions[i], n, cap)
            pts = comm.all_to_all(packed.send, group).reshape(n * cap, 3)
            pvalid = comm.all_to_all(packed.send_valid,
                                     group).reshape(n * cap) != 0
            inserted += vm.insert_points(level, pts, pvalid, resolutions[i],
                                         min_dists[i], MAX_ROUNDS, begin_tr,
                                         max_dirty)
            dropped += packed.dropped
        return (state, comm.sum_(inserted, group),
                comm.sum_(dropped, group))

    return update


def combine_moments(count, sum_rel, sum_outer, closest, closest_dist,
                    group):
    """The ranks' local moments combined as the reference does
    (:224-233): the counts and sums summed, the closest distance the
    minimum, the closest point the average of the ranks' closest points
    within 1e-12 of it. Returns (count, sum_rel, sum_outer, closest,
    closest_dist) as new tensors."""
    count = comm.sum_(count.clone(), group)
    sum_rel = comm.sum_(sum_rel.clone(), group)
    sum_outer = comm.sum_(sum_outer.clone(), group)
    best = comm.min_(closest_dist.clone(), group)
    is_best = closest_dist <= best + 1e-12
    closest = comm.sum_(torch.where(is_best[:, None], closest,
                                    torch.zeros_like(closest)), group)
    n_best = comm.sum_(is_best.to(closest.dtype), group)
    closest = closest / torch.clamp_min(n_best[:, None], 1.0)
    return count, sum_rel, sum_outer, closest, best


def make_sharded_ball_query_fn(options, level_index: int, nv: int,
                               group=None):
    """The distributed neighbourhood query (reference :208-245):
    query(state, queries [M, 3], query_valid [M], radius) -> (count [M],
    sum_rel [M, 3], sum_outer [M, 3, 3], closest [M, 3], closest_dist [M]),
    the same on every rank."""
    resolution = options.resolutions[level_index].resolution

    def query(state: ShardedMapState, queries, query_valid, radius: float):
        mom = vm.ball_search_moments(state.levels[level_index], queries,
                                     query_valid, radius, resolution, nv)
        return combine_moments(mom.count, mom.sum_rel, mom.sum_outer,
                               mom.closest, mom.closest_dist, group)

    return query
