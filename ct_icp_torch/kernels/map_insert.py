"""K3 map_insert: insert a point batch into one voxel-map level, in place.

Replaces the body of ``ct_icp_tpu/mapping/voxel_map.py::insert_points``
with ``with_normals=False`` (:366-522): ``_resolve_or_claim_slots``
(:198-305), the min-distance check, ``_elect_ranks`` (:327-363), the planar
scatter, the count add and ``num_points``. Kernel: ``csrc/map_insert.cu`` —
one thread per point, two launches per claim or election round, arbitration
by ``atomicMin`` of the point index (bit-exact with the reference's
scatter-min). Bound on the card: bytes of the min-distance check (the rows
of every point's voxel); the rounds are launch-bound at driving sizes.

Unlike the reference (a pure function), both versions update the level's
tensors in place: the map is ~100 MB and every frame rewrites a few rows.

A CPU tensor takes :func:`map_insert_plain`; a CUDA tensor launches the
kernel or raises.
"""

import numpy as np
import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels.candidate_gather import PROBE_WINDOW
from ct_icp_torch.ops import voxel as vx

EMPTY, TOMB = 0, 1
MAX_PROBES = 16
_BIG = 2 ** 62
_SCRATCH_ROWS = 7    # slot, hash, key, flags, ecount, rank, attempt

# launches of the CUDA kernel by map_insert (reset freely by callers)
launches = 0


def min_dist_sq(min_dist: float) -> float:
    """The min-distance threshold as the reference compares it: squared in
    float64, then rounded to float32."""
    return float(np.float32(float(min_dist) * float(min_dist)))


def _resolve_or_claim_slots(keys, pt_keys, h, valid):
    """Assign each point a slot for its voxel, claiming new voxels (in place
    on ``keys``). Returns (slot [N] int64, -1 unresolved; resolved [N])."""
    c = keys.shape[0]
    n = pt_keys.shape[0]
    dev = keys.device
    probes = torch.arange(PROBE_WINDOW, dtype=torch.int64, device=dev)
    kp = keys[(h[:, None] + probes[None, :]) & (c - 1)]
    hit = (kp == pt_keys[:, None]) & (
        torch.cumsum((kp == EMPTY).to(torch.int32), -1) == 0)
    first = torch.argmax(hit.to(torch.int32), dim=-1)
    resolved = hit.any(-1) & valid
    assigned = torch.where(resolved, (h + first) & (c - 1),
                           torch.full_like(h, -1))

    # claim rounds on the compacted unresolved subset; arbitration by the
    # ORIGINAL scan index, so the winners match the uncompacted election
    idx_n, _, ok = vx.compact_mask(valid & ~resolved, n)
    idx = idx_n.to(torch.int64)
    h_s, keys_s, pid_s = h[idx], pt_keys[idx], idx
    asg = torch.full_like(idx, -1)
    res = torch.zeros_like(ok)
    for r in range(MAX_PROBES):
        if not bool((ok & ~res).any()):
            break
        s = (h_s + r) & (c - 1)
        key = keys[s]
        newly = ~res & ok & (key == keys_s)
        asg = torch.where(newly, s, asg)
        res = res | newly
        attempt = ~res & ok & ((key == EMPTY) | (key == TOMB))
        claim = torch.full((c + 1,), _BIG, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(attempt, s, c), pid_s, "amin")
        winner = attempt & (claim[s] == pid_s)
        keys[s[winner]] = keys_s[winner]
        got = ~res & ok & (keys[s] == keys_s)
        asg = torch.where(got, s, asg)
        res = res | got
    back = ok & res
    assigned[idx[back]] = asg[back]
    resolved[idx[back]] = True
    return assigned, resolved & valid


def _elect_ranks(slots, eligible, c: int, max_rounds: int):
    """Rank of each eligible point among the eligible points of its slot
    (round r elects each slot's smallest unplaced index); -1 past
    ``max_rounds``."""
    n = slots.shape[0]
    pid = torch.arange(n, dtype=torch.int64, device=slots.device)
    rank = torch.full((n,), -1, dtype=torch.int64, device=slots.device)
    remaining = eligible.clone()
    for r in range(max_rounds):
        if not bool(remaining.any()):
            break
        claim = torch.full((c + 1,), _BIG, dtype=torch.int64,
                           device=slots.device)
        claim.scatter_reduce_(0, torch.where(remaining, slots, c), pid, "amin")
        winner = remaining & (claim[slots] == pid)
        rank = torch.where(winner, torch.full_like(rank, r), rank)
        remaining = remaining & ~winner
    return rank


def map_insert_plain(keys, count, points, num_points, pts, valid,
                     resolution: float, min_dist: float, max_rounds: int):
    """Plain PyTorch version of :func:`map_insert` (same rounds, same
    arbitration; compacts the claim subset and the eligible points as the
    reference does)."""
    c, p = keys.shape[0], points.shape[1] // 3
    n = pts.shape[0]
    coords = vx.voxel_coords(pts, resolution)
    h = vx.voxel_hash_u32(coords)
    pt_keys = vx.as_i32(vx.voxel_key_u32(coords))
    assigned, resolved = _resolve_or_claim_slots(keys, pt_keys, h, valid)
    slot = torch.where(resolved, assigned, torch.zeros_like(assigned))

    ecount = count[slot]
    rows = points[slot]
    ex, ey, ez = rows[:, 0:p], rows[:, p:2 * p], rows[:, 2 * p:]
    d2 = ((ex - pts[:, 0:1]) * (ex - pts[:, 0:1])
          + (ey - pts[:, 1:2]) * (ey - pts[:, 1:2])
          + (ez - pts[:, 2:3]) * (ez - pts[:, 2:3]))
    in_cap = torch.arange(p, dtype=torch.int32,
                          device=pts.device)[None, :] < ecount[:, None]
    d2 = torch.where(in_cap, d2, torch.full_like(d2, float("inf")))
    far_enough = (ecount == 0) | (d2.amin(-1) > min_dist_sq(min_dist))
    eligible = resolved & far_enough & (ecount < p)

    e_idx, _, ok_e = vx.compact_mask(eligible, n)
    e_idx = e_idx.to(torch.int64)
    slot_e = torch.where(ok_e, slot[e_idx], torch.full_like(e_idx, c))
    rank = _elect_ranks(torch.clamp(slot_e, 0, c - 1), ok_e, c, max_rounds)
    pos = ecount[e_idx] + rank
    accept = ok_e & (rank >= 0) & (pos < p)
    s_a, pos_a, pts_a = slot_e[accept], pos[accept], pts[e_idx[accept]]
    points[s_a, pos_a] = pts_a[:, 0]
    points[s_a, p + pos_a] = pts_a[:, 1]
    points[s_a, 2 * p + pos_a] = pts_a[:, 2]
    count.index_add_(0, s_a, torch.ones_like(s_a, dtype=torch.int32))
    inserted = accept.sum().to(torch.int32).reshape(1)
    num_points += inserted
    return inserted


def map_insert(keys, count, points, num_points, pts, valid,
               resolution: float, min_dist: float, max_rounds: int):
    """Insert ``pts`` f32[N, 3] (where ``valid`` bool[N]) into the level
    (keys int32[C] uint32 bit patterns, count int32[C], points f32[C, 3P],
    num_points int32[1]) in place: a new voxel takes the point; a voxel
    below capacity takes it iff it is farther than ``min_dist`` from every
    stored point; at most ``max_rounds`` points per voxel per call.
    Returns the number inserted, int32[1]."""
    if pts.device.type == "cpu":
        return map_insert_plain(keys, count, points, num_points, pts, valid,
                                resolution, min_dist, max_rounds)
    global launches
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"map_insert: no kernel for {dev}")
    c, row_len, n = keys.shape[0], points.shape[1], pts.shape[0]
    if c & (c - 1) or row_len % 3:
        raise ValueError("map_insert: C must be a power of two and points "
                         "rows 3P wide")
    for t, dtype, shape, name in (
            (keys, torch.int32, (c,), "keys"),
            (count, torch.int32, (c,), "count"),
            (points, torch.float32, (c, row_len), "points"),
            (num_points, torch.int32, (1,), "num_points"),
            (pts, torch.float32, (n, 3), "pts"),
            (valid, torch.bool, (n,), "valid")):
        build.check_tensor(t, dtype, shape, "map_insert", name, dev)
    scratch = torch.empty((_SCRATCH_ROWS * n,), dtype=torch.int32, device=dev)
    claim = torch.empty((c,), dtype=torch.int64, device=dev)
    inserted = torch.empty((1,), dtype=torch.int32, device=dev)
    fn = build.launcher("map_insert", "k3_map_insert", _ARGTYPES)
    status = fn(build.ptr(keys), build.ptr(count), build.ptr(points),
                build.ptr(num_points), build.ptr(pts), build.ptr(valid), n, c,
                row_len // 3, float(resolution), min_dist_sq(min_dist),
                int(max_rounds), build.ptr(scratch), build.ptr(claim),
                build.ptr(inserted), build.stream_of(pts))
    build.check_status(status, "map_insert")
    launches += 1
    return inserted


_ARGTYPES = (build.PTR,) * 6 + (build.INT,) * 3 + (build.FLOAT,) * 2 \
    + (build.INT,) + (build.PTR,) * 4
