"""K1 candidate_gather: voxel-map lookup + candidate selection, as slots.

Replaces ``ct_icp_tpu/mapping/voxel_map.py::find_slots_with_count`` (:168)
and ``::gather_candidate_planes`` (:668-719) up to its row gather, the
``max_candidates`` compaction included: it returns each candidate voxel's
slot (the reference's ``slot_c``) and usable count, and K2 reads the points
through the slots, so no [M, O', 3P] copy of the rows is made. Kernel:
``csrc/candidate_gather.cu``, one launch: a thread per (query, neighbour
voxel) probing its 8 keys by 16-byte loads; with the compaction, a warp
per query that probes its voxels into shared memory and places the kept
ones by ballot prefix counts. Bound on the card: bytes (the queries, the
probed key windows, the found counts, 8 B written per output pair).

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


def selection_order(nv: int, device=None):
    """int64 [O]: the neighbour offsets sorted by (|offset|^2, index), the
    order in which the reference's top_k keeps usable voxels."""
    off_d2 = (neighbor_offsets(nv, device).to(torch.int64) ** 2).sum(-1)
    return torch.argsort(off_d2 * (1 << 12)
                         + torch.arange(off_d2.shape[0], device=device))


def candidate_gather_plain(keys, count, queries, query_valid,
                           resolution: float, nv: int,
                           threshold_voxel_occupancy: int,
                           max_candidates: int = 0):
    """Plain PyTorch version: (slots [M, O'] int32, cnt_ok [M, O'] int32)."""
    offsets = neighbor_offsets(nv, queries.device)
    qc = vx.voxel_coords(queries, resolution)
    cand = qc[:, None, :] + offsets[None]
    slots, cnt = find_slots_with_count(keys, count, cand)
    valid_slot = slots >= 0
    slot_c = torch.where(valid_slot, slots, torch.zeros_like(slots))
    ok = (cnt >= threshold_voxel_occupancy) & valid_slot & query_valid[:, None]
    o = offsets.shape[0]
    if 0 < max_candidates < o:
        # the reference's top_k of (usable ? 1 - |offset|^2 / 100 : -1),
        # ties to the lower index: the usable voxels nearer first, then the
        # others by index; one distinct integer key per candidate, sorted
        off_d2 = (offsets.to(torch.int64) ** 2).sum(-1)
        key = (torch.where(ok, off_d2[None] << 12, 1 << 24)
               | torch.arange(o, device=queries.device)[None])
        sel = torch.argsort(key, dim=1)[:, :max_candidates]
        slot_c = torch.gather(slot_c, 1, sel)
        cnt = torch.gather(cnt, 1, sel)
        ok = torch.gather(ok, 1, sel)
    return (slot_c.to(torch.int32),
            torch.where(ok, cnt, torch.zeros_like(cnt)))


_orders = {}


def candidate_gather(keys, count, queries, query_valid, resolution: float,
                     nv: int, threshold_voxel_occupancy: int,
                     max_candidates: int = 0):
    """Candidate voxels of the (2nv+1)^3 around each query, as map slots.

    keys int32[C] (uint32 bit patterns, C a power of two), count int32[C],
    queries f32[M, 3], query_valid bool[M]. Returns (slots int32[M, O'],
    cnt_ok int32[M, O']): the voxel's slot (0 where it is absent) and its
    point count, zero where it is absent, below the occupancy threshold or
    the query is invalid. O' = O = (2nv+1)^3, or ``max_candidates`` when 0 <
    max_candidates < O: then the usable voxels come first, nearer offsets
    first, then the others by index (the reference's compaction)."""
    if queries.device.type == "cpu":
        return candidate_gather_plain(keys, count, queries, query_valid,
                                      resolution, nv,
                                      threshold_voxel_occupancy,
                                      max_candidates)
    global launches
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"candidate_gather: no kernel for {dev}")
    c, m = keys.shape[0], queries.shape[0]
    if c & (c - 1) or c < 8 or keys.data_ptr() % 16:
        raise ValueError("candidate_gather: keys must be a 16-byte aligned "
                         "table of C >= 8 slots, C a power of two")
    for t, dtype, shape, name in (
            (keys, torch.int32, (c,), "keys"),
            (count, torch.int32, (c,), "count"),
            (queries, torch.float32, (m, 3), "queries"),
            (query_valid, torch.bool, (m,), "query_valid")):
        build.check_tensor(t, dtype, shape, "candidate_gather", name, dev)
    o = (2 * nv + 1) ** 3
    if o > 1024:
        raise ValueError("candidate_gather: nv <= 4")
    compact = 0 < max_candidates < o
    o_out = max_candidates if compact else o
    slots = torch.empty((m, o_out), dtype=torch.int32, device=dev)
    cnt_ok = torch.empty((m, o_out), dtype=torch.int32, device=dev)
    args = (build.ptr(keys), build.ptr(count), build.ptr(queries),
            build.ptr(query_valid))
    tail = (float(resolution), int(threshold_voxel_occupancy))
    if compact:
        order = _orders.get((nv, dev))
        if order is None:
            order = selection_order(nv, dev).to(torch.int32)
            _orders[(nv, dev)] = order
        fn = build.launcher("candidate_gather", "k1_candidate_gather_compact",
                            _ARGTYPES_COMPACT)
        status = fn(*args, build.ptr(order), m, c, int(nv), *tail,
                    int(max_candidates), build.ptr(slots), build.ptr(cnt_ok),
                    build.stream_of(queries))
    else:
        fn = build.launcher("candidate_gather", "k1_candidate_gather",
                            _ARGTYPES)
        status = fn(*args, m, c, int(nv), *tail, build.ptr(slots),
                    build.ptr(cnt_ok), build.stream_of(queries))
    build.check_status(status, "candidate_gather")
    launches += 1
    return slots, cnt_ok


_ARGTYPES = (build.PTR,) * 4 + (build.INT,) * 3 + (build.FLOAT, build.INT) \
    + (build.PTR,) * 3
_ARGTYPES_COMPACT = (build.PTR,) * 5 + (build.INT,) * 3 \
    + (build.FLOAT, build.INT, build.INT) + (build.PTR,) * 3
