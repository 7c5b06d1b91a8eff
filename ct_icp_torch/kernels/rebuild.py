"""K7 rebuild_claim: the fresh hash table and each slot's writer row of the
floating-origin map rebase.

Replaces the table rebuild of ``ct_icp_tpu/mapping/voxel_map.py::
rebuild_level`` (:619-640): for every row with a key and points, the shift
is subtracted from its first point, its voxel, probe hash and identity key
are derived again, a slot is claimed for it in a fresh table by the
insert's claim rounds (``_resolve_or_claim_slots``: 16 rounds,
scatter-min of the row index, losers re-read), and each slot elects its
writer, the largest row index resolved to it (the reference's scatter-max);
``num_points`` is the sum of the writers' counts. K6
(``kernels/row_gather.py``) then moves the rows.

Kernel: ``csrc/rebuild_claim.cu`` — one cooperative launch: the fresh
table, the writers and the claim words cleared, each occupied row's voxel
derived and the row appended to a compact claimant list, the claim rounds
of ``csrc/claim.cuh`` (shared with K3, so the arbitration has one
implementation) over that list until every claimant is resolved or 16
rounds have run, an ``atomicMax`` election and the writers' counts summed;
grid barriers between the phases, no memset and no host sync. The rounds
each call ran are added to a device counter (:func:`rounds_counter`) that
only the measurement scripts read. Bound on the card: bytes (every key
read, the count of each live row and the first point of each occupied row
read once, table and writers written once); the grid barriers (3 + 2 a
round) set its time.

A CPU tensor takes :func:`rebuild_claim_plain`; a CUDA tensor launches the
kernel or raises.
"""

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import map_insert as k3
from ct_icp_torch.ops import voxel as vx

# slot, hash, key, flags, attempt, row and count of each claimant
_SCRATCH_ROWS = 7

# launches of the CUDA kernel by rebuild_claim (reset freely by callers)
launches = 0
# per device, the claim rounds the kernel ran (see rounds_counter)
_rounds = {}


def rebuild_claim_plain(keys, count, points, shift, resolution: float):
    """Plain PyTorch version of :func:`rebuild_claim` (the reference's
    rounds through ``map_insert._resolve_or_claim_slots`` on a fresh
    table, then a scatter-max of the row index and the writers' counts
    summed)."""
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
    src = src[:c]
    num_points = count[src.clamp_min(0)][src >= 0].sum(dtype=torch.int32)
    return table, src.to(torch.int32), num_points.reshape(1)


def rounds_counter(device):
    """The int32[1] tensor on ``device`` to which every kernel call adds
    the claim rounds it ran. Only the measurement scripts read it; the
    plain version leaves it alone."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _rounds.get(dev)
    if t is None:
        t = _rounds[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def reset_rounds():
    """Zero every device's rounds counter."""
    for t in _rounds.values():
        t.zero_()


def rebuild_claim(keys, count, points, shift, resolution: float):
    """The rebased table of a level (keys int32[C] uint32 bit patterns,
    count int32[C], points f32[C, 3P]) shifted by ``shift`` f32[3] (on the
    level's device): returns (table int32[C], src int32[C]: the row whose
    contents move to each slot, -1 for an empty slot, num_points int32[1]:
    the points of the rows that move)."""
    if keys.device.type == "cpu":
        return rebuild_claim_plain(keys, count, points, shift, resolution)
    global launches
    out = launch(keys, count, points, shift, resolution)
    launches += 1
    return out


def launch(keys, count, points, shift, resolution: float, defines=()):
    """One launch of ``csrc/rebuild_claim.cu`` on CUDA tensors, counted by
    no launch counter; ``defines`` pick a measurement variant of the kernel
    (``tools/exp_rebase.py``), none the main path's."""
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
    num_points = torch.empty((1,), dtype=torch.int32, device=dev)
    scratch = torch.empty((_SCRATCH_ROWS * c,), dtype=torch.int32, device=dev)
    claim = torch.empty((c,), dtype=torch.int64, device=dev)
    n_ctrl = build.launcher("rebuild_claim", "k7_ctrl_ints", ())()
    ctrl = torch.empty((n_ctrl,), dtype=torch.int32, device=dev)
    fn = build.launcher("rebuild_claim", "k7_rebuild_claim", _ARGTYPES,
                        defines)
    status = fn(build.ptr(keys), build.ptr(count), build.ptr(points),
                build.ptr(shift), c, row_len // 3, float(resolution),
                build.ptr(table), build.ptr(src), build.ptr(num_points),
                build.ptr(scratch), build.ptr(claim), build.ptr(ctrl),
                build.ptr(rounds_counter(dev)), build.stream_of(keys))
    build.check_status(status, "rebuild_claim")
    return table, src, num_points


_ARGTYPES = (build.PTR,) * 4 + (build.INT, build.INT, build.FLOAT) \
    + (build.PTR,) * 8
