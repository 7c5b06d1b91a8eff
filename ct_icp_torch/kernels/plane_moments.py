"""K2 plane_moments: in-radius moment rescore + descriptor.

Replaces ``ct_icp_tpu/mapping/voxel_map.py::moments_from_planes`` and
``::_knn_radius2`` (:722-818), ``ops/neighborhood.py::
description_from_moments`` (:94-120) and ``ops/eigen3.py::eigh3x3``
(:18-82). The reference rescored a cached copy of the candidate rows; this
reads the live map points through K1's slots. Kernel:
``csrc/plane_moments.cu`` — a group of ``K2_GROUP`` lanes (a warp) per
keypoint walks its live points only, the shell histogram in shared memory,
the eigensolves of a block's keypoints on the lanes of its first warp.
The radius is a scalar or one a query (the distance strategy's per-point
radius, the reference's ``radius_arr``). Bound on the card: bytes (each
distinct live map point once, the slot pairs, queries, radii and outputs).

A CPU tensor takes :func:`plane_moments_plain`; a CUDA tensor launches the
kernel or raises.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.ops.neighborhood import description_from_moments

KNN_BINS = 32

# launches of the CUDA kernel by plane_moments (reset freely by callers)
launches = 0


class Moments(NamedTuple):
    count: torch.Tensor          # int32 [M]
    sum_rel: torch.Tensor        # f32 [M, 3]   sums of (p - query)
    sum_outer: torch.Tensor      # f32 [M, 3, 3]
    closest: torch.Tensor        # f32 [M, 3]
    closest_dist: torch.Tensor   # f32 [M] (inf where count == 0)
    r_eff2: torch.Tensor         # f32 [M] squared radius the sums used
    normal: torch.Tensor         # f32 [M, 3] (sign arbitrary)
    a2d: torch.Tensor            # f32 [M]


def radius_sq(radius):
    """The squared radius: a host float32 for a scalar radius, else the
    f32[M] tensor of each query's radius squared in float32."""
    if torch.is_tensor(radius):
        return radius * radius
    r = np.float32(radius)
    return float(r * r)


def knn_radius2(d2, ok, query, m: int, radius, k_nearest: int,
                bins: int = KNN_BINS):
    """Per-query squared radius ~ the distance to the k-th nearest
    candidate: the smallest of ``bins`` nested radii whose in-radius count
    reaches k (full radius when none does or k <= 0). ``d2``, ``ok`` and
    ``query`` (the candidate's query index) are flat over the candidates;
    ``radius`` is a float or f32[M]."""
    rr = radius_sq(radius)
    if torch.is_tensor(rr):
        r2 = torch.clamp_min(rr, 1e-20)
    else:
        r2 = torch.full((m,), max(rr, 1e-20), dtype=d2.dtype,
                        device=d2.device)
    frac = (torch.arange(1, bins + 1, dtype=d2.dtype, device=d2.device)
            / bins) ** 2
    edges2 = r2[:, None] * frac[None, :]                        # [M, B]
    # each candidate's shell: the first edge >= d2 (bins = outside); the
    # in-radius count of edge b is the histogram's prefix sum up to b
    if torch.is_tensor(rr):
        shell = torch.searchsorted(edges2[query], d2[:, None])[:, 0]
    else:
        shell = torch.searchsorted(edges2[0].contiguous(), d2)
    shell = torch.where(ok, shell, torch.full_like(shell, bins))
    hist = torch.zeros((m * (bins + 1),), dtype=torch.int64, device=d2.device)
    hist.index_add_(0, query * (bins + 1) + shell, torch.ones_like(shell))
    cnt = torch.cumsum(hist.reshape(m, bins + 1)[:, :bins], dim=1)  # [M, B]
    reach = cnt >= max(k_nearest, 1)
    bin_idx = torch.argmax(reach.to(torch.int32), dim=-1)
    found = reach.any(-1) & (k_nearest > 0)
    r_eff2 = torch.gather(edges2, 1, bin_idx[:, None])[:, 0]
    return torch.where(found, r_eff2, r2)


def plane_moments_plain(points, slots, cnt_ok, queries, radius,
                        k_nearest: Optional[int],
                        cached_r_eff2=None) -> Moments:
    """Plain PyTorch version of :func:`plane_moments`, over the live
    candidates only (a voxel's points below its usable count). Candidate
    row (q, o) is ``points[slots[q, o]]``; the live points are read from it
    directly rather than from a [M, O', 3P] copy."""
    m, o = cnt_ok.shape
    p = points.shape[-1] // 3
    dev, dt = points.device, points.dtype
    rows = slots.long()                                       # [M, O']
    live = (torch.arange(p, dtype=torch.int32, device=dev)[None, None, :]
            < cnt_ok[..., None])
    qi, oi, pi = live.nonzero(as_tuple=True)
    ri = rows[qi, oi]
    x, y, z = points[ri, pi], points[ri, p + pi], points[ri, 2 * p + pi]
    dx = x - queries[qi, 0]
    dy = y - queries[qi, 1]
    dz = z - queries[qi, 2]
    d2 = dx * dx + dy * dy + dz * dz
    rr = radius_sq(radius)
    if torch.is_tensor(rr):
        ok = d2 <= rr[qi]
        r_eff2 = rr.clone()
    else:
        ok = d2 <= rr
        r_eff2 = torch.full((m,), rr, dtype=dt, device=dev)
    if k_nearest is not None:
        r_eff2 = (cached_r_eff2 if cached_r_eff2 is not None
                  else knn_radius2(d2, ok, qi, m, radius, k_nearest))
        ok = ok & (d2 <= r_eff2[qi])

    def per_query(v):
        # each device's in-order sum, the same from run to run: on the
        # card index_add_ adds by atomics in an order that changes, and
        # index_put_ accumulating sorts first; on the CPU index_add_ is in
        # order, and index_put_ accumulating adds from several threads
        out = torch.zeros(m, dtype=v.dtype, device=dev)
        if dev.type == "cpu":
            return out.index_add_(0, qi, v)
        return out.index_put_((qi,), v, accumulate=True)

    w = ok.to(dt)
    rx, ry, rz = dx * w, dy * w, dz * w
    count = per_query(ok.to(torch.int32))
    sum_rel = torch.stack([per_query(rx), per_query(ry), per_query(rz)], -1)
    sxx, sxy, sxz = per_query(rx * dx), per_query(rx * dy), per_query(rx * dz)
    syy, syz, szz = per_query(ry * dy), per_query(ry * dz), per_query(rz * dz)
    sum_outer = torch.stack([torch.stack([sxx, sxy, sxz], -1),
                             torch.stack([sxy, syy, syz], -1),
                             torch.stack([sxz, syz, szz], -1)], -2)

    # the closest: the first in-radius candidate (in voxel, point order) of
    # least d2; flat index 0 (point 0 of candidate 0) where there is none,
    # as an argmin over all-inf
    inf = float("inf")
    d2m = torch.where(ok, d2, torch.full_like(d2, inf))
    cd2 = torch.full((m,), inf, dtype=dt, device=dev).scatter_reduce(
        0, qi, d2m, "amin")
    flat = oi * p + pi
    none = o * p
    first = torch.full((m,), none, dtype=flat.dtype, device=dev)
    first = first.scatter_reduce(
        0, qi, torch.where(ok & (d2m == cd2[qi]), flat,
                           torch.full_like(flat, none)), "amin")
    first = torch.where(first == none, torch.zeros_like(first), first)
    q_all = torch.arange(m, device=dev)
    fr, fp = rows[q_all, first // p], first % p
    closest = torch.stack([points[fr, fp], points[fr, p + fp],
                           points[fr, 2 * p + fp]], -1)
    closest_dist = torch.where(count > 0, torch.sqrt(cd2),
                               torch.full_like(cd2, inf))
    desc = description_from_moments(count, sum_rel, sum_outer, queries)
    return Moments(count, sum_rel, sum_outer, closest, closest_dist, r_eff2,
                   desc.normal, desc.a2D)


def plane_moments(points, slots, cnt_ok, queries, radius,
                  k_nearest: Optional[int], cached_r_eff2=None) -> Moments:
    """Moments of the in-radius candidates of each query, and the
    descriptor (normal, a2D) they give.

    points f32[C, 3P] the level's planar rows, slots int32[M, O'] and
    cnt_ok int32[M, O'] from :func:`candidate_gather` on that level (point j
    of candidate o is live for j < cnt_ok), queries f32[M, 3], ``radius`` a
    float or f32[M] (a radius a query).
    ``k_nearest`` (None = no cap) caps the sums to ~the k nearest candidates
    by the 32-shell histogram radius, recomputed unless ``cached_r_eff2``
    f32[M] is given."""
    if queries.device.type == "cpu":
        return plane_moments_plain(points, slots, cnt_ok, queries, radius,
                                   k_nearest, cached_r_eff2)
    global launches
    out = launch(points, slots, cnt_ok, queries, radius, k_nearest,
                 cached_r_eff2)
    launches += 1
    return out


def launch(points, slots, cnt_ok, queries, radius,
           k_nearest: Optional[int], cached_r_eff2=None,
           defines=()) -> Moments:
    """One launch of ``csrc/plane_moments.cu`` on CUDA tensors, counted by
    no launch counter; ``defines`` pick a measurement variant of the kernel
    (``K2_GROUP=8`` or ``16``: ``tools/exp_moments.py``), none the main
    path's."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"plane_moments: no kernel for {dev}")
    c, row_len = points.shape
    m, o = slots.shape
    if row_len % 3:
        raise ValueError("plane_moments: points rows must be 3P wide")
    args = [(points, torch.float32, (c, row_len), "points"),
            (slots, torch.int32, (m, o), "slots"),
            (cnt_ok, torch.int32, (m, o), "cnt_ok"),
            (queries, torch.float32, (m, 3), "queries")]
    if cached_r_eff2 is not None:
        args.append((cached_r_eff2, torch.float32, (m,), "cached_r_eff2"))
    per_query = torch.is_tensor(radius)
    if per_query:
        args.append((radius, torch.float32, (m,), "radius"))
    for t, dtype, shape, name in args:
        build.check_tensor(t, dtype, shape, "plane_moments", name, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = Moments(
        count=torch.empty((m,), dtype=torch.int32, device=dev),
        sum_rel=torch.empty((m, 3), **f32),
        sum_outer=torch.empty((m, 3, 3), **f32),
        closest=torch.empty((m, 3), **f32),
        closest_dist=torch.empty((m,), **f32),
        r_eff2=torch.empty((m,), **f32),
        normal=torch.empty((m, 3), **f32),
        a2d=torch.empty((m,), **f32))
    fn = build.launcher("plane_moments", "k2_plane_moments", _ARGTYPES,
                        defines)
    status = fn(build.ptr(points), build.ptr(slots), build.ptr(cnt_ok),
                build.ptr(queries), m, o, row_len // 3,
                0.0 if per_query else radius_sq(radius),
                build.ptr(radius) if per_query else None,
                -1 if k_nearest is None else int(k_nearest),
                None if cached_r_eff2 is None else build.ptr(cached_r_eff2),
                *(build.ptr(t) for t in out), build.stream_of(queries))
    build.check_status(status, "plane_moments")
    return out


_ARGTYPES = (build.PTR,) * 4 + (build.INT,) * 3 \
    + (build.FLOAT, build.PTR, build.INT) + (build.PTR,) * 10
