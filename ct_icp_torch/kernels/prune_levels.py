"""K15 prune_levels: tombstone, in place, the voxels of every level of a
map whose first point lies farther than ``max_distance`` from a location.

Replaces ``ct_icp_tpu/mapping/voxel_map.py::prune_level`` (:596), the
reference's RemoveElementsFarFromLocation (map.h:305-322), which the
reference calls once a level: each occupied slot (key neither EMPTY nor
TOMB) beyond the distance gets the TOMB key, count 0 and flag 0, so probe
chains stay intact; ``num_points`` drops by the points removed. With a
``gate`` (a device bool, the frame's assessment) nothing changes where it
is false, and the host reads nothing.

Kernel: ``csrc/prune_levels.cu`` — one launch over every level of a frame
(the levels' blocks one after another, each level's tables in one argument
struct, as K9 lays them out), a thread a slot: the key first, the three
planar first-point words only for an occupied slot; d2 left to right
without FMA against max_distance^2 rounded as the plain version rounds it
(:func:`threshold`); the removed counts summed by block, one integer atomic
a block a level, and the last block subtracts each level's total from its
``num_points`` and resets the per-device accumulators. Bound on the card:
bytes (every key, the occupied slots' first points, the tombstones'
writes).

A CPU tensor takes :func:`prune_levels_plain`; a CUDA tensor launches the
kernel or raises.
"""

import ctypes

import numpy as np
import torch

from ct_icp_torch.kernels import build

THREADS = 256        # a slot a thread, csrc/prune_levels.cu's block
MAX_LEVELS = 8       # csrc/prune_levels.cu's kMaxLevels
EMPTY = 0
TOMB = 1
# launches of the CUDA kernel by prune_levels (reset freely by callers)
launches = 0
# per device, the int32[MAX_LEVELS + 1] accumulators and ticket the kernel
# leaves zero
_scratch = {}


def threshold(max_distance) -> float:
    """max_distance^2 as the plain version compares it: the product of two
    Python floats (doubles), rounded to float32 against the float32 d2."""
    return float(np.float32(float(max_distance) * float(max_distance)))


def prune_level_plain(level, location, max_distance: float, gate=None):
    """Plain PyTorch version of :func:`prune_levels` on one level (``level``
    a ``MapLevel``)."""
    p = level.points.shape[1] // 3
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


def prune_levels_plain(levels, location, max_distance: float, gate=None):
    """Plain PyTorch version of :func:`prune_levels`: each level in turn."""
    for level in levels:
        prune_level_plain(level, location, max_distance, gate)


def layout(caps):
    """(first block of each level, blocks of the grid) of a launch over
    levels of ``caps`` slots. Raises unless 1 <= levels <= MAX_LEVELS and
    every level has a slot."""
    if not 1 <= len(caps) <= MAX_LEVELS:
        raise ValueError(f"prune_levels: {len(caps)} levels, 1 to "
                         f"{MAX_LEVELS}")
    first, blocks = [], 0
    for c in caps:
        if c < 1:
            raise ValueError(f"prune_levels: a level of {c} slots")
        first.append(blocks)
        blocks += -(-c // THREADS)
    return first, blocks


def prune_levels(levels, location, max_distance: float, gate=None):
    """Tombstone, in place on every level ``levels[l]`` (a ``MapLevel``:
    keys / count / nflags int32[C_l], points f32[C_l, 3P_l], num_points
    int32[1]), each occupied voxel whose first point lies farther than
    ``max_distance`` (a host number) from ``location`` (f32[3] on the
    levels' device); only where the bool tensor ``gate`` holds, when
    given. One launch on the card; returns nothing."""
    levels = list(levels)
    if not levels:
        return
    if levels[0].keys.device.type == "cpu":
        prune_levels_plain(levels, location, max_distance, gate)
        return
    global launches
    dev = levels[0].keys.device
    if dev.type != "cuda":
        raise ValueError(f"prune_levels: no kernel for {dev}")
    caps, ps = [], []
    for lv in levels:
        cap, row = lv.points.shape
        if row % 3:
            raise ValueError("prune_levels: points rows must be 3P wide")
        for t, dtype, shape, name in (
                (lv.keys, torch.int32, (cap,), "keys"),
                (lv.count, torch.int32, (cap,), "count"),
                (lv.nflags, torch.int32, (cap,), "nflags"),
                (lv.num_points, torch.int32, (1,), "num_points"),
                (lv.points, torch.float32, (cap, row), "points")):
            build.check_tensor(t, dtype, shape, "prune_levels", name, dev)
        caps.append(cap)
        ps.append(row // 3)
    first, blocks = layout(caps)
    build.check_tensor(location, torch.float32, (3,), "prune_levels",
                       "location", dev)
    if gate is not None:
        build.check_tensor(gate, torch.bool, (), "prune_levels", "gate", dev)
    n_lv = len(levels)

    def ptrs(ts):
        return (ctypes.c_void_p * n_lv)(*(t.data_ptr() for t in ts))

    ints = ctypes.c_int * n_lv
    fn = build.launcher("prune_levels", "k15_prune_levels", _ARGTYPES)
    status = fn(n_lv, ptrs([lv.keys for lv in levels]),
                ptrs([lv.count for lv in levels]),
                ptrs([lv.nflags for lv in levels]),
                ptrs([lv.num_points for lv in levels]),
                ptrs([lv.points for lv in levels]), ints(*ps), ints(*caps),
                ints(*first), blocks, build.ptr(location),
                threshold(max_distance),
                None if gate is None else build.ptr(gate),
                build.ptr(_scratch_of(dev)), build.stream_of(levels[0].keys))
    build.check_status(status, "prune_levels")
    launches += 1


def _scratch_of(dev):
    t = _scratch.get(dev)
    if t is None:
        t = _scratch[dev] = torch.zeros(MAX_LEVELS + 1, dtype=torch.int32,
                                        device=dev)
    return t


_ARGTYPES = ((build.INT,) + (build.PTR,) * 8 + (build.INT, build.PTR,
                                                 build.FLOAT, build.PTR,
                                                 build.PTR, build.PTR))
