"""K9 evict_voxels: empty the listed voxels of a map's levels, in place.

Replaces ``ct_icp_tpu/mapping/voxel_map.py::evict_voxels`` (:564-593), the
backend replay's eviction, called there once a level: every listed
coordinate's voxel, where present, gets count 0 and flag 0 and keeps its
key (probe chains stay intact, and a later insert of the voxel refills the
same slot); each level's ``num_points`` drops by the points removed, which
the call returns. The reference also rebuilds its TPU probe window
(``win``); the port has none.

Kernel: ``csrc/evict_voxels.cu`` — one launch over every level of a replay
(:func:`evict_levels`; the levels' blocks one after another, each level's
tables and row count in one argument struct), a thread a coordinate on K1's
probe
(``csrc/probe.cuh``), the count taken by ``atomicExch`` (a slot listed
twice is emptied and counted once, as the reference's ``sum(count) -
sum(new_count)`` counts it), a block sum and one integer atomic a block,
and the last block to finish subtracts each level's total from its
``num_points`` and resets the per-device accumulators: no memset, no host
read. :func:`evict_voxels` (one level, rows picked by a mask) launches the
same kernel with one level. Bound on the card: bytes (the listed
coordinates and their probed key windows, each found slot's count read and
count and flag written); a launch's floor is above it at a replay's sizes
(:func:`empty_launch`).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernel or
raises.
"""

import ctypes

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import candidate_gather as k1

THREADS = 256        # a coordinate a thread, csrc/evict_voxels.cu's block
MAX_LEVELS = 8       # csrc/evict_voxels.cu's kMaxLevels
# launches of the CUDA kernel by evict_voxels and evict_levels (reset freely
# by callers)
launches = 0
# per device, the int32[MAX_LEVELS + 1] accumulators and ticket the kernel
# leaves zero
_scratch = {}


def evict_voxels_plain(keys, count, nflags, num_points, coords, valid):
    """Plain PyTorch version of :func:`evict_voxels` (the reference's
    ``find_slots`` and scatters)."""
    slot, _ = k1.find_slots_with_count(keys, count, coords)
    hit = valid & (slot >= 0)
    tgt = torch.unique(slot[hit])
    removed = count[tgt].sum(dtype=torch.int32).reshape(1)
    count[tgt] = 0
    nflags[tgt] = 0
    num_points.sub_(removed)
    return removed


def evict_levels_plain(levels, coords, counts):
    """Plain PyTorch version of :func:`evict_levels`: each level evicted in
    turn, the first ``counts[l]`` rows of ``coords[l]`` listed."""
    removed = []
    for lv, c, n in zip(levels, coords, counts):
        valid = torch.arange(c.shape[0], device=c.device) < n
        removed.append(evict_voxels_plain(lv.keys, lv.count, lv.nflags,
                                          lv.num_points, c, valid))
    removed = torch.cat(removed)
    return torch.cat([removed, removed.sum(dtype=torch.int32).reshape(1)])


def evict_voxels(keys, count, nflags, num_points, coords, valid):
    """Empty, in place, the voxels at ``coords`` int32[M, 3] where ``valid``
    bool[M] holds, in the level given by keys / count / nflags int32[C]
    (keys: uint32 bit patterns, C a power of two) and num_points int32[1].
    Returns the points removed, int32[1] on the level's device."""
    if keys.device.type == "cpu":
        return evict_voxels_plain(keys, count, nflags, num_points, coords,
                                  valid)
    m = coords.shape[0]
    build.check_tensor(valid, torch.bool, (m,), "evict_voxels", "valid",
                       keys.device)
    return _launch([(keys, count, nflags, num_points)], [coords], [m],
                   valid)[:1]


def evict_levels(levels, coords, counts):
    """Empty, in place, on every level ``levels[l]`` (a ``MapLevel``: keys /
    count / nflags int32[C_l], num_points int32[1]) the voxels at the first
    ``counts[l]`` (host ints) rows of ``coords[l]`` int32[M_l, 3], in one
    launch on the card. Returns int32[L + 1] on the device: the points
    removed from each level, then their total."""
    if len(levels) != len(coords) or len(levels) != len(counts):
        raise ValueError("evict_levels: one coordinate array and one count "
                         "a level")
    if levels[0].keys.device.type == "cpu":
        return evict_levels_plain(levels, coords, counts)
    for c, n in zip(coords, counts):
        if not 0 <= int(n) <= c.shape[0]:
            raise ValueError(f"evict_levels: {n} rows of {c.shape[0]}")
    return _launch([(lv.keys, lv.count, lv.nflags, lv.num_points)
                    for lv in levels], coords, [int(n) for n in counts], None)


def _launch(levels, coords, rows, valid):
    global launches
    dev = levels[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"evict_voxels: no kernel for {dev}")
    n_lv = len(levels)
    if not 1 <= n_lv <= MAX_LEVELS:
        raise ValueError(f"evict_voxels: {n_lv} levels, 1 to {MAX_LEVELS}")
    caps = []
    for (keys, count, nflags, num_points), c in zip(levels, coords):
        cap, m = keys.shape[0], c.shape[0]
        if cap & (cap - 1) or cap < 8 or keys.data_ptr() % 16:
            raise ValueError("evict_voxels: keys must be a 16-byte aligned "
                             "table of C >= 8 slots, C a power of two")
        for t, dtype, shape, name in (
                (keys, torch.int32, (cap,), "keys"),
                (count, torch.int32, (cap,), "count"),
                (nflags, torch.int32, (cap,), "nflags"),
                (num_points, torch.int32, (1,), "num_points"),
                (c, torch.int32, (m, 3), "coords")):
            build.check_tensor(t, dtype, shape, "evict_voxels", name, dev)
        caps.append(cap)
    removed = torch.empty((n_lv + 1,), dtype=torch.int32, device=dev)

    def ptrs(ts):
        return (ctypes.c_void_p * n_lv)(*(None if t is None else t.data_ptr()
                                          for t in ts))

    ints = ctypes.c_int * n_lv
    fn = build.launcher("evict_voxels", "k9_evict_voxels", _ARGTYPES)
    status = fn(n_lv, *(ptrs([lv[j] for lv in levels]) for j in range(4)),
                ptrs(coords), ptrs([valid] * n_lv), ints(*rows), ints(*caps),
                build.ptr(_scratch_of(dev)), build.ptr(removed),
                build.stream_of(levels[0][0]))
    build.check_status(status, "evict_voxels")
    launches += 1
    return removed


def _scratch_of(dev):
    t = _scratch.get(dev)
    if t is None:
        t = _scratch[dev] = torch.zeros(MAX_LEVELS + 1, dtype=torch.int32,
                                        device=dev)
    return t


def grid_blocks(rows) -> int:
    """The eviction's blocks for levels of ``rows`` coordinates each."""
    return max(1, sum((m + THREADS - 1) // THREADS for m in rows))


def empty_launch(blocks: int):
    """An empty kernel on a grid of ``blocks`` CTAs of the eviction's block
    size, on the current stream: the floor of a launch of that shape
    (measurement only; no launch counter sees it)."""
    fn = build.launcher("evict_voxels", "k9_empty", (build.INT, build.PTR))
    build.check_status(fn(blocks, torch.cuda.current_stream().cuda_stream),
                       "k9_empty")


_ARGTYPES = (build.INT,) + (build.PTR,) * 11
