"""K1 candidate_gather: voxel-map lookup + candidate row gather.

Replaces ``ct_icp_tpu/mapping/voxel_map.py::find_slots_with_count`` (:168)
and ``::gather_candidate_planes`` (:668-719), its ``max_candidates``
compaction included. Kernel: ``csrc/candidate_gather.cu`` (one warp per
(query, neighbour voxel): an 8-key probe by ballot, then a coalesced copy of
the planar row; with the compaction, a probe-and-rank launch per query,
then the copy of the kept rows). Bound on the card: bytes — the gathered
rows are read once and written once.

A CPU tensor takes :func:`candidate_gather_plain`; a CUDA tensor launches the
kernel or raises.
"""

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.ops import voxel as vx

PROBE_WINDOW = 8

# launches of the CUDA kernel by candidate_gather (reset freely by callers)
launches = 0


def neighbor_offsets(nv: int, device=None):
    """[O, 3] int32 offsets of the (2nv+1)^3 neighbour voxels, x fastest
    (``_neighbor_offsets`` order)."""
    r = torch.arange(-nv, nv + 1, dtype=torch.int32, device=device)
    zz, yy, xx = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)], -1)


def find_slots_with_count(keys, count, coords):
    """Lookup: voxel coords [..., 3] -> (slot [...] int64, count [...] int32).

    A direct linear probe of PROBE_WINDOW slots from h & (C-1); the first
    key match before the first EMPTY wins. slot is -1 (count 0) where the
    voxel is absent."""
    c = keys.shape[0]
    shape = coords.shape[:-1]
    coords = coords.reshape(-1, 3)
    h = vx.voxel_hash_u32(coords)
    k2 = vx.as_i32(vx.voxel_key_u32(coords))
    probes = torch.arange(PROBE_WINDOW, dtype=torch.int64, device=keys.device)
    at = (h[:, None] + probes[None, :]) & (c - 1)
    kp = keys[at]
    is_empty = kp == 0
    hit = (kp == k2[:, None]) & (torch.cumsum(is_empty.to(torch.int32), -1) == 0)
    j = torch.argmax(hit.to(torch.int32), dim=-1)
    any_hit = hit.any(-1)
    slot = (h + j) & (c - 1)
    cnt = count[slot]
    slot = torch.where(any_hit, slot, torch.full_like(slot, -1))
    cnt = torch.where(any_hit, cnt, torch.zeros_like(cnt))
    return slot.reshape(shape), cnt.reshape(shape)


def candidate_gather_plain(keys, count, points, queries, query_valid,
                           resolution: float, nv: int,
                           threshold_voxel_occupancy: int,
                           max_candidates: int = 0):
    """Plain PyTorch version: (rows [M, O', 3P], cnt_ok [M, O'] int32)."""
    offsets = neighbor_offsets(nv, queries.device)
    qc = vx.voxel_coords(queries, resolution)
    cand = qc[:, None, :] + offsets[None]
    slots, cnt = find_slots_with_count(keys, count, cand)
    valid_slot = slots >= 0
    slot_c = torch.where(valid_slot, slots, torch.zeros_like(slots))
    ok = (cnt >= threshold_voxel_occupancy) & valid_slot & query_valid[:, None]
    o = offsets.shape[0]
    if 0 < max_candidates < o:
        # the reference's top_k of (usable, nearer offset), ties to the
        # lower index: one distinct integer key per candidate, sorted
        off_d2 = (offsets.to(torch.int64) ** 2).sum(-1)
        key = (torch.where(ok, 0, 1).to(torch.int64) << 24
               | (off_d2 << 12)[None]
               | torch.arange(o, device=queries.device)[None])
        sel = torch.argsort(key, dim=1)[:, :max_candidates]
        slot_c = torch.gather(slot_c, 1, sel)
        cnt = torch.gather(cnt, 1, sel)
        ok = torch.gather(ok, 1, sel)
    rows = points[slot_c]
    return rows, torch.where(ok, cnt, torch.zeros_like(cnt))


def candidate_gather(keys, count, points, queries, query_valid,
                     resolution: float, nv: int,
                     threshold_voxel_occupancy: int,
                     max_candidates: int = 0):
    """Candidate rows of the (2nv+1)^3 voxels around each query.

    keys int32[C] (uint32 bit patterns, C a power of two), count int32[C],
    points f32[C, 3P], queries f32[M, 3], query_valid bool[M]. Returns
    (rows f32[M, O', 3P], cnt_ok int32[M, O']): the voxel's point count,
    zero where it is absent, below the occupancy threshold or the query is
    invalid. O' = O = (2nv+1)^3, or ``max_candidates`` when 0 <
    max_candidates < O: then the usable voxels come first, nearer offsets
    first (the reference's compaction)."""
    if queries.device.type == "cpu":
        return candidate_gather_plain(keys, count, points, queries,
                                      query_valid, resolution, nv,
                                      threshold_voxel_occupancy,
                                      max_candidates)
    global launches
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"candidate_gather: no kernel for {dev}")
    c, m, row_len = keys.shape[0], queries.shape[0], points.shape[1]
    if c & (c - 1) or row_len % 3:
        raise ValueError("candidate_gather: C must be a power of two and "
                         "points rows 3P wide")
    for t, dtype, shape, name in (
            (keys, torch.int32, (c,), "keys"),
            (count, torch.int32, (c,), "count"),
            (points, torch.float32, (c, row_len), "points"),
            (queries, torch.float32, (m, 3), "queries"),
            (query_valid, torch.bool, (m,), "query_valid")):
        build.check_tensor(t, dtype, shape, "candidate_gather", name, dev)
    o = (2 * nv + 1) ** 3
    if o > 1024:
        raise ValueError("candidate_gather: nv <= 4")
    args = (build.ptr(keys), build.ptr(count), build.ptr(points),
            build.ptr(queries), build.ptr(query_valid), m, c, row_len,
            int(nv), float(resolution), int(threshold_voxel_occupancy))
    if 0 < max_candidates < o:
        rows = torch.empty((m, max_candidates, row_len), dtype=torch.float32,
                           device=dev)
        cnt_ok = torch.empty((m, max_candidates), dtype=torch.int32,
                             device=dev)
        sel = torch.empty((m, max_candidates), dtype=torch.int32, device=dev)
        fn = build.launcher("candidate_gather", "k1_candidate_gather_compact",
                            _ARGTYPES_COMPACT)
        status = fn(*args, int(max_candidates), build.ptr(rows),
                    build.ptr(cnt_ok), build.ptr(sel),
                    build.stream_of(queries))
    else:
        rows = torch.empty((m, o, row_len), dtype=torch.float32, device=dev)
        cnt_ok = torch.empty((m, o), dtype=torch.int32, device=dev)
        fn = build.launcher("candidate_gather", "k1_candidate_gather",
                            _ARGTYPES)
        status = fn(*args, build.ptr(rows), build.ptr(cnt_ok),
                    build.stream_of(queries))
    build.check_status(status, "candidate_gather")
    launches += 1
    return rows, cnt_ok


_ARGTYPES = (build.PTR,) * 5 + (build.INT,) * 4 + (build.FLOAT, build.INT) \
    + (build.PTR,) * 3
_ARGTYPES_COMPACT = (build.PTR,) * 5 + (build.INT,) * 4 \
    + (build.FLOAT, build.INT, build.INT) + (build.PTR,) * 4
