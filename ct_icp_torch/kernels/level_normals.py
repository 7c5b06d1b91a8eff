"""K10 level_normals: the map export's normal refit of the listed voxels.

Replaces ``ct_icp_tpu/mapping/voxel_map.py::_voxel_plane_fit`` (:524-546)
and ``::recompute_level_normals`` (:549-561): of the listed slots, every
slot holding a voxel's key and at least 5 points gets the plane fit of its
points (moments about its first point, ``description_from_moments``), the
normal oriented toward ``location`` (flipped where (barycenter - location)
. normal > 0) and flag 2; the other listed slots keep their normal and
flag. The results are NEW tensors, a row for each listed slot, as the
reference refits a copy of the level for the export. The export
(``Odometry.get_map_points``) lists the occupied slots it copies out;
``voxel_map.recompute_level_normals`` lists every slot.

Kernel: ``csrc/level_normals.cu`` — one launch over the S listed slots,
blocks of 256 threads, a thread a listed slot (256 slots a block, fewer
for a short list): a slot not refit is copied through by its thread, a
refit slot goes into the block's queue in shared memory; a group of lanes
a queued slot sums its moments (a lane a point, shuffles; a warp where the
grid has at most one block an SM, else 8 lanes: :func:`lanes`), then a
thread a queued slot runs the eigensolve (``csrc/eigh3.cuh``, K2's) and
the orientation.
Bound on the card: bytes (each listed slot's index, key, count, normal and
flag out, the old normal and flag of the listed slots not refit, the refit
slots' live points).

A CPU tensor takes :func:`level_normals_plain`; a CUDA tensor launches the
kernel or raises.
"""

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import map_insert as k3
from ct_icp_torch.ops.neighborhood import description_from_moments

MIN_POINTS = 5
REFIT_FLAG = 2

# launches of the CUDA kernel by level_normals (reset freely by callers)
launches = 0


def refit_mask(keys, count):
    """bool[C]: the slots the refit rewrites (a voxel's key, >= 5 points)."""
    return (keys != k3.EMPTY) & (keys != k3.TOMB) & (count >= MIN_POINTS)


def plane_fit(rows, count, p: int):
    """The reference's ``_voxel_plane_fit`` of planar rows f32[D, 3P] with
    ``count`` int32[D] points: (normal [D, 3], absolute barycenter [D, 3])
    from the moments about each row's first point."""
    dx, dy, dz = rows[:, 0:p], rows[:, p:2 * p], rows[:, 2 * p:3 * p]
    mask = (torch.arange(p, dtype=torch.int32, device=rows.device)[None, :]
            < count[:, None]).to(rows.dtype)
    ox, oy, oz = dx[:, 0], dy[:, 0], dz[:, 0]
    rx = (dx - ox[:, None]) * mask
    ry = (dy - oy[:, None]) * mask
    rz = (dz - oz[:, None]) * mask
    count_f = mask.sum(-1)
    sum_rel = torch.stack([rx.sum(-1), ry.sum(-1), rz.sum(-1)], -1)
    sxy, sxz, syz = (rx * ry).sum(-1), (rx * rz).sum(-1), (ry * rz).sum(-1)
    sum_outer = torch.stack([
        torch.stack([(rx * rx).sum(-1), sxy, sxz], -1),
        torch.stack([sxy, (ry * ry).sum(-1), syz], -1),
        torch.stack([sxz, syz, (rz * rz).sum(-1)], -1)], -2)
    origin = torch.stack([ox, oy, oz], -1)
    desc = description_from_moments(count_f, sum_rel, sum_outer, origin)
    return desc.normal, desc.barycenter


def level_normals_plain(keys, count, points, normals, nflags, location,
                        slots):
    """Plain PyTorch version of :func:`level_normals`: the reference's fit,
    computed on the listed slots that are refit (the reference fits every
    slot and keeps the refit ones' results; each slot's fit depends on its
    row alone)."""
    p = points.shape[1] // 3
    slots = slots.long()
    refit = refit_mask(keys[slots], count[slots])
    rows = slots[refit]
    normal, bary = plane_fit(points[rows], count[rows], p)
    flip = torch.sum((bary - location) * normal, dim=-1) > 0
    out_normals = normals[slots]
    out_nflags = nflags[slots]
    out_normals[refit] = torch.where(flip[:, None], -normal, normal)
    out_nflags[refit] = REFIT_FLAG
    return out_normals, out_nflags


def level_normals(keys, count, points, normals, nflags, location, slots):
    """The refit normals and flags of the listed slots ``slots`` int32[S]
    of a level (keys int32[C] uint32 bit patterns, count / nflags int32[C],
    points f32[C, 3P], normals f32[C, 3]) oriented toward ``location``
    f32[3] (on the level's device): returns new (normals f32[S, 3],
    nflags int32[S]); the level is left as it is."""
    global launches
    dev = keys.device
    if dev.type == "cpu":
        return level_normals_plain(keys, count, points, normals, nflags,
                                   location, slots)
    if dev.type != "cuda":
        raise ValueError(f"level_normals: no kernel for {dev}")
    c, row_len, s = keys.shape[0], points.shape[1], slots.shape[0]
    if row_len % 3:
        raise ValueError("level_normals: points rows must be 3P wide")
    for t, dtype, shape, name in (
            (keys, torch.int32, (c,), "keys"),
            (count, torch.int32, (c,), "count"),
            (points, torch.float32, (c, row_len), "points"),
            (normals, torch.float32, (c, 3), "normals"),
            (nflags, torch.int32, (c,), "nflags"),
            (location, torch.float32, (3,), "location"),
            (slots, torch.int32, (s,), "slots")):
        build.check_tensor(t, dtype, shape, "level_normals", name, dev)
    out_normals = torch.empty((s, 3), dtype=torch.float32, device=dev)
    out_nflags = torch.empty((s,), dtype=torch.int32, device=dev)
    fn = build.launcher("level_normals", "k10_level_normals", _ARGTYPES)
    status = fn(build.ptr(keys), build.ptr(count), build.ptr(points),
                build.ptr(normals), build.ptr(nflags), build.ptr(location),
                build.ptr(slots), s, row_len // 3, build.ptr(out_normals),
                build.ptr(out_nflags), build.stream_of(keys))
    build.check_status(status, "level_normals")
    if s:
        launches += 1       # an empty list launches nothing
    return out_normals, out_nflags


def lanes(n_slots: int) -> int:
    """The lanes a queued slot's moments take in a kernel call over
    ``n_slots`` listed slots on the current card (32 where the grid has at
    most one block an SM, else 8)."""
    return build.launcher("level_normals", "k10_lanes", (build.INT,))(n_slots)


def empty_launch(n_slots: int):
    """An empty kernel on the grid of a call over ``n_slots`` listed slots,
    on the current stream: the floor of a launch of that shape
    (measurement only; no launch counter sees it)."""
    fn = build.launcher("level_normals", "k10_empty", (build.INT, build.PTR))
    build.check_status(fn(n_slots, torch.cuda.current_stream().cuda_stream),
                       "k10_empty")


_ARGTYPES = (build.PTR,) * 7 + (build.INT, build.INT) + (build.PTR,) * 3
