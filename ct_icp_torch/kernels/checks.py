"""Kernel-vs-plain comparisons, shared by the card tests
(tests/test_torch_kernels_gpu.py) and chip_smoke.py.

Each check runs a kernel wrapper and its plain PyTorch version on the same
CUDA inputs and raises AssertionError on a disagreement. Tolerances:
  * integer and hash outputs (slots, counts, shells, keys, ranks) and point
    rows: identical;
  * K2 float sums: summed in another order (warp tree vs torch reduction),
    so within 1e-4 of each query's second-moment scale; the normal within
    1e-3 (|cos| of the angle, sign free) where the neighborhood is planar
    (a2D > 0.5 and >= 10 points); a2D within 1e-3 where >= 5 points.
Each returns {"max_abs_err": float} for the float outputs (0 if identical).
"""

import torch

from ct_icp_torch.kernels import candidate_gather as k1
from ct_icp_torch.kernels import map_insert as k3
from ct_icp_torch.kernels import plane_moments as k2


def _same(a, b, what):
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        bad = (a != b).sum().item() if a.shape == b.shape else "shape"
        raise AssertionError(f"{what}: kernel != plain ({bad} differ)")


def check_candidate_gather(level, queries, query_valid, resolution, nv,
                           threshold):
    args = (level.keys, level.count, level.points, queries, query_valid,
            resolution, nv, threshold)
    rows, cnt = k1.candidate_gather(*args)
    prow, pcnt = k1.candidate_gather_plain(*args)
    torch.cuda.synchronize()
    _same(cnt, pcnt, "candidate_gather cnt_ok")
    _same(rows, prow, "candidate_gather rows")
    return {"max_abs_err": 0.0}


def check_plane_moments(rows, cnt_ok, queries, radius, k_nearest,
                        cached_r_eff2=None):
    got = k2.plane_moments(rows, cnt_ok, queries, radius, k_nearest,
                           cached_r_eff2)
    want = k2.plane_moments_plain(rows, cnt_ok, queries, radius, k_nearest,
                                  cached_r_eff2)
    torch.cuda.synchronize()
    _same(got.count, want.count, "plane_moments count")
    _same(got.r_eff2, want.r_eff2, "plane_moments r_eff2")
    _same(got.closest, want.closest, "plane_moments closest")
    scale = want.sum_outer.abs().amax(dim=(1, 2)) + 1e-6
    err_rel = ((got.sum_rel - want.sum_rel).abs().amax(-1) / scale.sqrt())
    err_out = ((got.sum_outer - want.sum_outer).abs().amax(dim=(1, 2))
               / scale)
    live = want.count > 0
    cd = (got.closest_dist[live] - want.closest_dist[live]).abs()
    if err_rel.max() > 1e-4 or err_out.max() > 1e-4:
        raise AssertionError(f"plane_moments sums: {err_rel.max().item()}, "
                             f"{err_out.max().item()} > 1e-4")
    if live.any() and (cd / want.closest_dist[live].clamp_min(1e-6)).max() \
            > 1e-6:
        raise AssertionError("plane_moments closest_dist beyond 1e-6")
    planar = (want.count >= 10) & (want.a2d > 0.5)
    cosang = (got.normal * want.normal).sum(-1).abs()
    if planar.any() and (1.0 - cosang[planar]).max() > 1e-3:
        raise AssertionError("plane_moments normal beyond 1e-3")
    full = want.count >= 5
    a2d_err = (got.a2d[full] - want.a2d[full]).abs()
    if full.any() and a2d_err.max() > 1e-3:
        raise AssertionError(f"plane_moments a2D: {a2d_err.max().item()}")
    return {"max_abs_err": max(
        (got.sum_rel - want.sum_rel).abs().max().item(),
        (got.sum_outer - want.sum_outer).abs().max().item())}


def check_map_insert(level, pts, valid, resolution, min_dist, max_rounds):
    """Both versions insert into their own copy of ``level``; the copies
    must end identical. Returns the number inserted too."""
    a = [t.clone() for t in (level.keys, level.count, level.points,
                             level.num_points)]
    b = [t.clone() for t in a]
    n_a = k3.map_insert(*a, pts, valid, resolution, min_dist, max_rounds)
    n_b = k3.map_insert_plain(*b, pts, valid, resolution, min_dist,
                              max_rounds)
    torch.cuda.synchronize()
    for x, y, name in zip(a + [n_a], b + [n_b],
                          ("keys", "count", "points", "num_points",
                           "inserted")):
        _same(x, y, f"map_insert {name}")
    return {"max_abs_err": 0.0, "inserted": int(n_a[0])}
