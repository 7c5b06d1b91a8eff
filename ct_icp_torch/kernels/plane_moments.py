"""K2 plane_moments: in-radius moment rescore + descriptor.

Replaces ``ct_icp_tpu/mapping/voxel_map.py::moments_from_planes`` and
``::_knn_radius2`` (:722-818), ``ops/neighborhood.py::
description_from_moments`` (:94-120) and ``ops/eigen3.py::eigh3x3``
(:18-82). Kernel: ``csrc/plane_moments.cu`` — one warp per keypoint over its
O x P candidates, the shell histogram in shared memory, the eigensolve in
registers. Bound on the card: bytes (the candidate rows, read once per
pass).

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


def _radius_sq(radius) -> float:
    r = np.float32(radius)
    return float(r * r)


def knn_radius2(d2, ok, radius: float, k_nearest: int, bins: int = KNN_BINS):
    """Per-query squared radius ~ the distance to the k-th nearest
    candidate: the smallest of ``bins`` nested radii whose in-radius count
    reaches k (full radius when none does or k <= 0)."""
    m = d2.shape[0]
    r2 = max(_radius_sq(radius), 1e-20)
    frac = (torch.arange(1, bins + 1, dtype=d2.dtype, device=d2.device)
            / bins) ** 2
    edges2 = torch.full((m, 1), r2, dtype=d2.dtype, device=d2.device) \
        * frac[None, :]                                         # [M, B]
    inside = ok[..., None] & (d2[..., None] <= edges2[:, None, None, :])
    cnt = inside.sum(dim=(1, 2))                                # [M, B]
    reach = cnt >= max(k_nearest, 1)
    bin_idx = torch.argmax(reach.to(torch.int32), dim=-1)
    found = reach.any(-1) & (k_nearest > 0)
    r_eff2 = torch.gather(edges2, 1, bin_idx[:, None])[:, 0]
    return torch.where(found, r_eff2, torch.full_like(r_eff2, r2))


def plane_moments_plain(rows, cnt_ok, queries, radius: float,
                        k_nearest: Optional[int],
                        cached_r_eff2=None) -> Moments:
    """Plain PyTorch version of :func:`plane_moments`."""
    m = queries.shape[0]
    p = rows.shape[-1] // 3
    x, y, z = rows[..., 0:p], rows[..., p:2 * p], rows[..., 2 * p:3 * p]
    dx = x - queries[:, None, 0:1]
    dy = y - queries[:, None, 1:2]
    dz = z - queries[:, None, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    rr = _radius_sq(radius)
    in_cap = torch.arange(p, dtype=torch.int32,
                          device=rows.device)[None, None, :] < cnt_ok[..., None]
    ok = in_cap & (d2 <= rr)
    r_eff2 = torch.full((m,), rr, dtype=rows.dtype, device=rows.device)
    if k_nearest is not None:
        r_eff2 = (cached_r_eff2 if cached_r_eff2 is not None
                  else knn_radius2(d2, ok, radius, k_nearest))
        ok = ok & (d2 <= r_eff2[:, None, None])

    w = ok.to(queries.dtype)
    rx, ry, rz = dx * w, dy * w, dz * w
    count = ok.sum(dim=(1, 2)).to(torch.int32)
    sum_rel = torch.stack([rx.sum((1, 2)), ry.sum((1, 2)), rz.sum((1, 2))], -1)
    sxx, sxy, sxz = (rx * dx).sum((1, 2)), (rx * dy).sum((1, 2)), \
        (rx * dz).sum((1, 2))
    syy, syz, szz = (ry * dy).sum((1, 2)), (ry * dz).sum((1, 2)), \
        (rz * dz).sum((1, 2))
    sum_outer = torch.stack([torch.stack([sxx, sxy, sxz], -1),
                             torch.stack([sxy, syy, syz], -1),
                             torch.stack([sxz, syz, szz], -1)], -2)

    d2m = torch.where(ok, d2, torch.full_like(d2, float("inf"))).reshape(m, -1)
    amin = torch.argmin(d2m, dim=-1)[:, None]
    closest = torch.stack([torch.gather(v.reshape(m, -1), 1, amin)[:, 0]
                           for v in (x, y, z)], -1)
    cd2 = torch.gather(d2m, 1, amin)[:, 0]
    closest_dist = torch.where(count > 0, torch.sqrt(cd2),
                               torch.full_like(cd2, float("inf")))
    desc = description_from_moments(count, sum_rel, sum_outer, queries)
    return Moments(count, sum_rel, sum_outer, closest, closest_dist, r_eff2,
                   desc.normal, desc.a2D)


def plane_moments(rows, cnt_ok, queries, radius: float,
                  k_nearest: Optional[int], cached_r_eff2=None) -> Moments:
    """Moments of the in-radius candidates of each query, and the
    descriptor (normal, a2D) they give.

    rows f32[M, O, 3P] planar candidate rows, cnt_ok int32[M, O] usable
    points per voxel, queries f32[M, 3]. ``k_nearest`` (None = no cap) caps
    the sums to ~the k nearest candidates by the 32-shell histogram radius,
    recomputed unless ``cached_r_eff2`` f32[M] is given."""
    if queries.device.type == "cpu":
        return plane_moments_plain(rows, cnt_ok, queries, radius, k_nearest,
                                   cached_r_eff2)
    global launches
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"plane_moments: no kernel for {dev}")
    m, o, row_len = rows.shape
    if row_len % 3:
        raise ValueError("plane_moments: rows must be 3P wide")
    args = [(rows, torch.float32, (m, o, row_len), "rows"),
            (cnt_ok, torch.int32, (m, o), "cnt_ok"),
            (queries, torch.float32, (m, 3), "queries")]
    if cached_r_eff2 is not None:
        args.append((cached_r_eff2, torch.float32, (m,), "cached_r_eff2"))
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
    fn = build.launcher("plane_moments", "k2_plane_moments", _ARGTYPES)
    status = fn(build.ptr(rows), build.ptr(cnt_ok), build.ptr(queries), m, o,
                row_len // 3, _radius_sq(radius),
                -1 if k_nearest is None else int(k_nearest),
                None if cached_r_eff2 is None else build.ptr(cached_r_eff2),
                *(build.ptr(t) for t in out), build.stream_of(queries))
    build.check_status(status, "plane_moments")
    launches += 1
    return out


_ARGTYPES = (build.PTR,) * 3 + (build.INT,) * 3 + (build.FLOAT, build.INT) \
    + (build.PTR,) * 10
