"""K7 rebuild_claim: the fresh hash table and each slot's writer row of the
floating-origin map rebase.

Replaces the table rebuild of ``ct_icp_tpu/mapping/voxel_map.py::
rebuild_level`` (:619-640): for every row with a key and points, the shift
is subtracted from its first point, its voxel, probe hash and identity key
are derived again, a slot is claimed for it in a fresh table by the
insert's claim rounds (``_resolve_or_claim_slots``: 16 rounds,
scatter-min of the row index, losers re-read), and each slot elects its
writer, the largest row index resolved to it (the reference's scatter-max).
K6 (``kernels/row_gather.py``) then moves the rows.

Kernel: ``csrc/rebuild_claim.cu`` — one thread per row, the claim rounds of
``csrc/claim.cuh`` (shared with K3, so the arbitration has one
implementation), an ``atomicMax`` election; no host sync. Bound on the card:
bytes (every key read, the count of each live row and the first point of
each occupied row read once, table and writers written once); the 33 round
launches dominate its time.

A CPU tensor takes :func:`rebuild_claim_plain`; a CUDA tensor launches the
kernel or raises.
"""

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import map_insert as k3
from ct_icp_torch.ops import voxel as vx

_SCRATCH_ROWS = 5    # slot, hash, key, flags, attempt

# launches of the CUDA kernel by rebuild_claim (reset freely by callers)
launches = 0


def rebuild_claim_plain(keys, count, points, shift, resolution: float):
    """Plain PyTorch version of :func:`rebuild_claim` (the reference's
    rounds through ``map_insert._resolve_or_claim_slots`` on a fresh
    table, then a scatter-max of the row index)."""
    c, p = keys.shape[0], points.shape[1] // 3
    occupied = (keys != k3.EMPTY) & (keys != k3.TOMB) & (count > 0)
    first = torch.stack([points[:, 0], points[:, p], points[:, 2 * p]],
                        -1) - shift
    coords = vx.voxel_coords(first, resolution)
    table = torch.zeros_like(keys)
    assigned, resolved = k3._resolve_or_claim_slots(
        table, vx.as_i32(vx.voxel_key_u32(coords)), vx.voxel_hash_u32(coords),
        occupied)
    rows = torch.arange(c, dtype=torch.int64, device=keys.device)
    src = torch.full((c + 1,), -1, dtype=torch.int64, device=keys.device)
    src.scatter_reduce_(0, torch.where(resolved, assigned,
                                       torch.full_like(assigned, c)),
                        rows, "amax")
    return table, src[:c].to(torch.int32)


def rebuild_claim(keys, count, points, shift, resolution: float):
    """The rebased table of a level (keys int32[C] uint32 bit patterns,
    count int32[C], points f32[C, 3P]) shifted by ``shift`` f32[3] (on the
    level's device): returns (table int32[C], src int32[C]: the row whose
    contents move to each slot, -1 for an empty slot)."""
    if keys.device.type == "cpu":
        return rebuild_claim_plain(keys, count, points, shift, resolution)
    global launches
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"rebuild_claim: no kernel for {dev}")
    c, row_len = keys.shape[0], points.shape[1]
    if c & (c - 1) or row_len % 3:
        raise ValueError("rebuild_claim: C must be a power of two and points "
                         "rows 3P wide")
    for t, dtype, shape, name in (
            (keys, torch.int32, (c,), "keys"),
            (count, torch.int32, (c,), "count"),
            (points, torch.float32, (c, row_len), "points"),
            (shift, torch.float32, (3,), "shift")):
        build.check_tensor(t, dtype, shape, "rebuild_claim", name, dev)
    table = torch.empty((c,), dtype=torch.int32, device=dev)
    src = torch.empty((c,), dtype=torch.int32, device=dev)
    scratch = torch.empty((_SCRATCH_ROWS * c,), dtype=torch.int32, device=dev)
    claim = torch.empty((c,), dtype=torch.int64, device=dev)
    fn = build.launcher("rebuild_claim", "k7_rebuild_claim", _ARGTYPES)
    status = fn(build.ptr(keys), build.ptr(count), build.ptr(points),
                build.ptr(shift), c, row_len // 3, float(resolution),
                build.ptr(table), build.ptr(src), build.ptr(scratch),
                build.ptr(claim), build.stream_of(keys))
    build.check_status(status, "rebuild_claim")
    launches += 1
    return table, src


_ARGTYPES = (build.PTR,) * 4 + (build.INT, build.INT, build.FLOAT) \
    + (build.PTR,) * 5
