"""K12 knn_search: the bounded exact k-NN search of the map, as the
reference's C++ runs it.

Replaces ``ct_icp_tpu/mapping/voxel_map.py::radius_search`` (:917-937)
over ``::_candidate_planes`` (:821-842): the k nearest live candidates of
each query whose squared distance is within the radius, sorted by that
distance, ties to the lower flat index o * P + p (``jax.lax.top_k``'s order
on -d2; the reference C++'s bounded priority queue, map.h:449-514). The
candidates are K1's: point p of candidate voxel o is live for p <
cnt_ok[q, o] and is read from ``points[slots[q, o]]``, so no [M, O, 3P]
copy of the rows is made. Kernel: ``csrc/knn_search.cu``, one launch: a
warp a query keeps its k best (d2, index) pairs sorted in shared memory
and merges 32 live candidates at a time. Bound on the card: bytes (the
distinct live candidate points read once, the (slot, count) pairs, the
queries and radii, the outputs), counted as K2's is.

A CPU tensor takes :func:`knn_search_plain`; a CUDA tensor launches the
kernel or raises.
"""

from typing import NamedTuple

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels.plane_moments import radius_sq

# the most neighbours a query keeps (the kernel's shared-memory list)
MAX_K = 128

# launches of the CUDA kernel by knn_search (reset freely by callers)
launches = 0


class Neighbors(NamedTuple):
    points: torch.Tensor     # f32 [M, k, 3] (0 where not ``mask``)
    mask: torch.Tensor       # bool [M, k]
    dist: torch.Tensor       # f32 [M, k] sqrt(d2) (inf where not ``mask``)


def knn_search_plain(points, slots, cnt_ok, queries, radius,
                     k: int) -> Neighbors:
    """Plain PyTorch version of :func:`knn_search`, in the reference's
    rounds: d2 of every candidate (dx*dx + dy*dy + dz*dz, left to right),
    the live in-radius mask, ``torch.topk`` on an int64 key that orders by
    d2 and then by the flat index (d2 >= 0, so its float32 bit pattern
    orders as it does; masked-out candidates take +inf), and the gather."""
    m, o = cnt_ok.shape
    p = points.shape[-1] // 3
    if k > o * p:
        raise ValueError(f"knn_search: k = {k} > {o * p} candidates")
    dev = points.device
    rr = radius_sq(radius)
    rows = points[slots.long()]                               # [M, O, 3P]
    x, y, z = rows[..., :p], rows[..., p:2 * p], rows[..., 2 * p:]
    dx = x - queries[:, None, 0:1]
    dy = y - queries[:, None, 1:2]
    dz = z - queries[:, None, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    live = (torch.arange(p, dtype=torch.int32, device=dev)[None, None, :]
            < cnt_ok[..., None])
    lim = rr[:, None, None] if torch.is_tensor(rr) else rr
    ok = (live & (d2 <= lim)).reshape(m, o * p)
    inf = torch.full_like(d2, float("inf")).reshape(m, o * p)
    d2m = torch.where(ok, d2.reshape(m, o * p), inf)
    flat = torch.arange(o * p, dtype=torch.int64, device=dev)
    key = (d2m.view(torch.int32).to(torch.int64) << 32) | flat[None, :]
    top, _ = torch.topk(key, k, dim=1, largest=False, sorted=True)
    idx = top & 0xFFFFFFFF
    nd2 = torch.gather(d2m, 1, idx)
    mask = torch.isfinite(nd2)
    cand = torch.stack([x, y, z], -1).reshape(m, o * p, 3)
    pts = torch.gather(cand, 1, idx[..., None].expand(m, k, 3))
    pts = torch.where(mask[..., None], pts, torch.zeros_like(pts))
    dist = torch.where(mask, torch.sqrt(nd2), torch.full_like(nd2,
                                                              float("inf")))
    return Neighbors(pts, mask, dist)


def knn_search(points, slots, cnt_ok, queries, radius, k: int) -> Neighbors:
    """The k nearest in-radius map points of each query, sorted by distance
    (ties to the lower candidate index o * P + p).

    points f32[C, 3P] the level's planar rows; slots int32[M, O] and cnt_ok
    int32[M, O] from :func:`candidate_gather` over all O voxels (no
    compaction) on that level; queries f32[M, 3]; radius a float or f32[M];
    k a static count (1 <= k <= MAX_K). Returns ``Neighbors``: entries past
    a query's in-radius candidates are masked out, their points 0 and
    their distances inf (the reference fills them with whatever candidate
    its top_k picked; only the masked-in entries are compared)."""
    if queries.device.type == "cpu":
        return knn_search_plain(points, slots, cnt_ok, queries, radius, k)
    global launches
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"knn_search: no kernel for {dev}")
    c, row_len = points.shape
    m, o = slots.shape
    if row_len % 3:
        raise ValueError("knn_search: points rows must be 3P wide")
    if not 1 <= k <= MAX_K or k > o * (row_len // 3):
        raise ValueError(f"knn_search: need 1 <= k <= {MAX_K} and k at most "
                         f"the {o * (row_len // 3)} candidates, got {k}")
    args = [(points, torch.float32, (c, row_len), "points"),
            (slots, torch.int32, (m, o), "slots"),
            (cnt_ok, torch.int32, (m, o), "cnt_ok"),
            (queries, torch.float32, (m, 3), "queries")]
    per_query = torch.is_tensor(radius)
    if per_query:
        args.append((radius, torch.float32, (m,), "radius"))
    for t, dtype, shape, name in args:
        build.check_tensor(t, dtype, shape, "knn_search", name, dev)
    out = Neighbors(
        points=torch.empty((m, k, 3), dtype=torch.float32, device=dev),
        mask=torch.empty((m, k), dtype=torch.bool, device=dev),
        dist=torch.empty((m, k), dtype=torch.float32, device=dev))
    fn = build.launcher("knn_search", "k12_knn_search", _ARGTYPES)
    status = fn(build.ptr(points), build.ptr(slots), build.ptr(cnt_ok),
                build.ptr(queries), m, o, row_len // 3,
                0.0 if per_query else radius_sq(radius),
                build.ptr(radius) if per_query else None, int(k),
                *(build.ptr(t) for t in out), build.stream_of(queries))
    build.check_status(status, "knn_search")
    launches += 1
    return out


_ARGTYPES = (build.PTR,) * 4 + (build.INT,) * 3 + (build.FLOAT, build.PTR,
                                                    build.INT) \
    + (build.PTR,) * 4
