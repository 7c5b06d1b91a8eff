"""K9 evict_voxels: empty the listed voxels of a map level, in place.

Replaces ``ct_icp_tpu/mapping/voxel_map.py::evict_voxels`` (:564-593), the
backend replay's eviction: every valid coordinate's voxel, where present,
gets count 0 and flag 0 and keeps its key (probe chains stay intact, and a
later insert of the voxel refills the same slot); ``num_points`` drops by
the points removed, which the call returns. The reference also rebuilds its
TPU probe window (``win``); the port has none.

Kernel: ``csrc/evict_voxels.cu`` — one launch, a thread per coordinate on
K1's probe (``csrc/probe.cuh``), the count taken by ``atomicExch`` (a slot
listed twice is emptied and counted once, as the reference's
``sum(count) - sum(new_count)`` counts it), a block sum and one integer
atomic a block, and the last block to finish subtracts the total from
``num_points`` and resets the per-device accumulator: no memset, no host
read. Bound on the card: bytes (every valid flag, the valid coordinates
and their probed key windows, each found slot's count read and count and
flag written).

A CPU tensor takes :func:`evict_voxels_plain`; a CUDA tensor launches the
kernel or raises.
"""

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import candidate_gather as k1

# launches of the CUDA kernel by evict_voxels (reset freely by callers)
launches = 0
# per device, the int32[2] accumulator and ticket the kernel leaves zero
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


def _scratch_of(dev):
    t = _scratch.get(dev)
    if t is None:
        t = _scratch[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    return t


def evict_voxels(keys, count, nflags, num_points, coords, valid):
    """Empty, in place, the voxels at ``coords`` int32[M, 3] where ``valid``
    bool[M] holds, in the level given by keys / count / nflags int32[C]
    (keys: uint32 bit patterns, C a power of two) and num_points int32[1].
    Returns the points removed, int32[1] on the level's device."""
    if keys.device.type == "cpu":
        return evict_voxels_plain(keys, count, nflags, num_points, coords,
                                  valid)
    global launches
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"evict_voxels: no kernel for {dev}")
    c, m = keys.shape[0], coords.shape[0]
    if c & (c - 1) or c < 8 or keys.data_ptr() % 16:
        raise ValueError("evict_voxels: keys must be a 16-byte aligned table "
                         "of C >= 8 slots, C a power of two")
    for t, dtype, shape, name in (
            (keys, torch.int32, (c,), "keys"),
            (count, torch.int32, (c,), "count"),
            (nflags, torch.int32, (c,), "nflags"),
            (num_points, torch.int32, (1,), "num_points"),
            (coords, torch.int32, (m, 3), "coords"),
            (valid, torch.bool, (m,), "valid")):
        build.check_tensor(t, dtype, shape, "evict_voxels", name, dev)
    removed = torch.empty((1,), dtype=torch.int32, device=dev)
    fn = build.launcher("evict_voxels", "k9_evict_voxels", _ARGTYPES)
    status = fn(build.ptr(keys), build.ptr(count), build.ptr(nflags),
                build.ptr(num_points), build.ptr(coords), build.ptr(valid),
                m, c, build.ptr(_scratch_of(dev)), build.ptr(removed),
                build.stream_of(keys))
    build.check_status(status, "evict_voxels")
    launches += 1
    return removed


_ARGTYPES = (build.PTR,) * 6 + (build.INT, build.INT) + (build.PTR,) * 3
