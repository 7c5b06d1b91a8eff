"""Kernel-vs-plain comparisons, shared by the card tests
(tests/test_torch_kernels_gpu.py) and chip_smoke.py.

Each check runs a kernel wrapper and its plain PyTorch version on the same
CUDA inputs and raises AssertionError on a disagreement. Tolerances:
  * integer and hash outputs (K1's slots and counts, with the normal filter
    too, K2's counts, shell radii and closest points, with a radius a
    query too, keys, ranks) and point rows: identical;
  * K12 (the exact k-NN search, a scalar or a per-query radius): the
    neighbours, the mask and the distances identical (d2 and its order
    come from the same round-to-nearest operations, sqrt is correctly
    rounded on both);
  * K2 float sums: summed in another order (warp tree vs torch reduction),
    so within 1e-4 of each query's second-moment scale; the normal within
    1e-3 (|cos| of the angle, sign free) where the neighborhood is planar
    (a2D > 0.5 and >= 10 points); a2D within 1e-3 where >= 5 points;
    with the full descriptor (``full``): the covariance within 1e-4 of the
    second-moment scale, the barycenter within 1e-5 of it (its square root,
    in metres) plus 1e-6 of the query's coordinates, linearity and
    planarity within 1e-4 where >= 5 points, the line within 1e-3 (|cos|)
    where the largest eigenvalue stands 5 % clear of the middle one, and
    the ROBUST classes (planarity > 0.8, else linearity > 0.8: the
    reference defaults) identical wherever both values lie more than 1e-4
    from their thresholds; the keypoints within 1e-4 of one are counted
    (``near_threshold``), not compared;
  * K4 (grid election) and K13 (the exact samplers): indices, count and
    validity identical;
  * K6 (row gather, one table or several in one launch) and K7 (the
    rebase's table, writers and num_points), and the whole
    ``rebuild_level`` they make up: identical (keys, counts, points,
    normals, flags, num_points);
  * K5 (LM loop), any residual family, loss, prior size and Jacobian
    branch, one step from the same state: J^T W J and J^T W r within
    1e-4 of their largest entry (K rows summed in another order: warp and
    cluster sums vs BLAS), the trial cost and the cost at delta = 0 within
    1e-5 relative, delta within 1e-3 of its largest entry (the 12x12 solve
    carries the sums' rounding through a matrix of condition ~1e3 after the
    Jacobi scaling); a whole call (up to the same number of steps, each
    stopping at done) ends within 1 mm and 0.01 deg, its accept/reject
    decisions, and so its step count, being free to differ where a trial
    cost ties the current one within rounding;
  * K8 (CT-BA block), both modes on the same window: one iteration's J^T J
    and J^T r within 1e-4 of their largest entry (rows summed by threads,
    CTAs and the cluster vs BLAS), the per-frame cost and the total within
    1e-5 relative (1e-7 absolute, for an empty frame), in mode "gn" the
    updated poses within 1e-5 m and 1e-4 deg (the 12x12 solve, a Cholesky
    on the card and an LU in torch, carries the sums' rounding); for n
    inner iterations in one launch, the last one held so (but for J^T r,
    the gradient of a nearly converged window, which float32 rounding
    alone moves by more: held instead against the plain version in float64
    from the same iterate, the kernel's gap to it within 10 times the
    float32 plain version's, or 1e-6 of its largest entry) from the
    kernel's own iterate n - 1, and the final poses to the plain version's
    n iterations within the same 1e-5 m and 1e-4 deg; a second launch
    bit-identical to the first (the partials are summed in a fixed order),
    and one launch of n iterations bit-identical to n launches of one;
  * K9 (eviction, one level or every level in one launch): each copy's
    keys, counts, flags and num_points and the points removed identical;
  * K10 (the export's normal refit of the listed slots): the flags, the
    set of refit slots and the normals of the other slots identical; a
    refit slot's normal within
    1e-4 by component where the two smallest eigenvalues of its
    covariance (float64) are more than 5 % of the largest apart, with
    sign where the orientation is decided (|(barycenter - location) .
    normal| > 1e-3 m) and up to sign where it is not (where the two
    eigenvalues meet, the eigenvector is not defined, and sums taken in
    another order turn it freely: those slots are counted, not compared);
  * K11 (owner pack): the send buffers, their flags and the dropped count
    identical (integer ranks, copied points);
  * K14 (scan unpack and CT transform, distort_raw's too): identical (the
    plain version's operations in its order, torch's order of the
    four-term quaternion sums included);
  * K15 (the prune of every level in one launch): keys, counts, flags and
    num_points identical on every level;
  * K16 (compact_mask): indices, count and validity identical;
  * K17 (the k-NN descriptor): the list (points, mask, distances)
    identical, as K12's; the descriptor as K2's (the moments summed in
    another order): the covariance within 1e-4 of the query's largest
    second-moment sum, the normal, a2D and, with the full descriptor, the
    rest as in ``_check_descriptor``;
  * K3's rank-0 slots (the with_normals insert's dirty list) identical,
    with the refit of those slots held as K10 is;
  * K8's halo launch (a rank's slice of a sharded window): held as a
    single-iteration "gn" launch is, and its J^T r also against the plain
    version in float64 from the same poses: the kernel's gap to it within
    10 times the float32 plain version's (or 1e-6 of its largest entry).
Each returns {"max_abs_err": float} for the float outputs (0 if identical).
"""

import numpy as np
import torch

from ct_icp_torch.config.options import LeastSquares
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.kernels import candidate_gather as k1
from ct_icp_torch.kernels import compact_mask as k16
from ct_icp_torch.kernels import ct_ba_block as k8
from ct_icp_torch.kernels import evict_voxels as k9
from ct_icp_torch.kernels import exact_sample as k13
from ct_icp_torch.kernels import grid_sample as k4
from ct_icp_torch.kernels import knn_search as k12
from ct_icp_torch.kernels import level_normals as k10
from ct_icp_torch.kernels import lm_step as k5
from ct_icp_torch.kernels import map_insert as k3
from ct_icp_torch.kernels import owner_pack as k11
from ct_icp_torch.kernels import plane_moments as k2
from ct_icp_torch.kernels import prune_levels as k15
from ct_icp_torch.kernels import rebuild as k7
from ct_icp_torch.kernels import row_gather as k6
from ct_icp_torch.kernels import scan_transform as k14
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.parallel import ct_ba as ba


def _same(a, b, what):
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: kernel != plain ({a.dtype} "
                                 f"{tuple(a.shape)} against {b.dtype} "
                                 f"{tuple(b.shape)})")
        differ = (a != b).reshape(-1)
        at = differ.nonzero().reshape(-1)[:8].tolist()
        gap = (a.double() - b.double()).abs().max().item()
        raise AssertionError(f"{what}: kernel != plain ({int(differ.sum())} "
                             f"differ, flat indices {at}, largest gap "
                             f"{gap:.3g})")


def check_candidate_gather(level, queries, query_valid, resolution, nv,
                           threshold, max_candidates=0, sensor_location=None):
    """K1 against its plain version; with ``sensor_location`` (f32[3]),
    with the normal filter on the level's normals and flags."""
    args = (level.keys, level.count, queries, query_valid, resolution, nv,
            threshold, max_candidates)
    filt = ({} if sensor_location is None else dict(
        normals=level.normals, nflags=level.nflags,
        sensor_location=sensor_location))
    slots, cnt = k1.candidate_gather(*args, **filt)
    pslots, pcnt = k1.candidate_gather_plain(*args, **filt)
    torch.cuda.synchronize()
    _same(cnt, pcnt, "candidate_gather cnt_ok")
    _same(slots, pslots, "candidate_gather slots")
    return {"max_abs_err": 0.0}


def check_plane_moments(points, slots, cnt_ok, queries, radius, k_nearest,
                        cached_r_eff2=None, full=False):
    got = k2.plane_moments(points, slots, cnt_ok, queries, radius, k_nearest,
                           cached_r_eff2, full=full)
    want = k2.plane_moments_plain(points, slots, cnt_ok, queries, radius,
                                  k_nearest, cached_r_eff2, full=full)
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
    five = want.count >= 5
    a2d_err = (got.a2d[five] - want.a2d[five]).abs()
    if five.any() and a2d_err.max() > 1e-3:
        raise AssertionError(f"plane_moments a2D: {a2d_err.max().item()}")
    out = {"max_abs_err": max(
        (got.sum_rel - want.sum_rel).abs().max().item(),
        (got.sum_outer - want.sum_outer).abs().max().item())}
    if full:
        out.update(_check_descriptor(got, want, queries, scale, five))
    return out


# the ROBUST solver's class thresholds the check counts keypoints near
# (CTICPOptions' threshold_planarity and threshold_linearity)
CLASS_THRESHOLDS = (0.8, 0.8)


def robust_classes(planarity, linearity, thresholds=CLASS_THRESHOLDS):
    """solver._build_problem's classes: 1 planar, 2 linear, 0 other."""
    planar = planarity > thresholds[0]
    linear = ~planar & (linearity > thresholds[1])
    return torch.where(planar, 1, torch.where(linear, 2, 0))


def _check_descriptor(got, want, queries, scale, five,
                      what="plane_moments"):
    """K2's (or K17's) full descriptor against the plain version's
    (tolerances in the module docstring)."""
    cov_err = ((got.covariance - want.covariance).abs().amax(dim=(1, 2))
               / scale)
    bar_err = ((got.barycenter - want.barycenter).abs().amax(-1)
               - 1e-6 * queries.abs().amax(-1)) / scale.sqrt()
    if cov_err.max() > 1e-4 or bar_err.max() > 1e-5:
        raise AssertionError(f"{what} covariance / barycenter: "
                             f"{cov_err.max().item()}, "
                             f"{bar_err.max().item()}")
    for name in ("linearity", "planarity"):
        err = (getattr(got, name)[five] - getattr(want, name)[five]).abs()
        if five.any() and err.max() > 1e-4:
            raise AssertionError(f"{what} {name}: {err.max().item()}")
    vals = torch.linalg.eigvalsh(want.covariance.double()).flip(-1).abs()
    clear = five & (vals[:, 0] > 1.05 * vals[:, 1])
    cos_line = (got.line * want.line).sum(-1).abs()
    if clear.any() and (1.0 - cos_line[clear]).max() > 1e-3:
        raise AssertionError(f"{what} line beyond 1e-3")
    tol = 1e-4
    near = torch.zeros_like(five)
    for name, thr in zip(("planarity", "linearity"), CLASS_THRESHOLDS):
        near |= ((getattr(got, name) - thr).abs() <= tol) | (
            (getattr(want, name) - thr).abs() <= tol)
    cls_g = robust_classes(got.planarity, got.linearity)
    cls_w = robust_classes(want.planarity, want.linearity)
    differ = (cls_g != cls_w) & ~near
    if differ.any():
        raise AssertionError(f"{what} classes: {int(differ.sum())} "
                             "differ away from the thresholds")
    return {"near_threshold": int(near.sum()),
            "classes": [int((cls_w == c).sum()) for c in (0, 1, 2)],
            "descriptor_max_abs_err": max(
                (got.covariance - want.covariance).abs().max().item(),
                (got.barycenter - want.barycenter).abs().max().item(),
                (got.linearity - want.linearity).abs().max().item(),
                (got.planarity - want.planarity).abs().max().item())}


def check_knn_search(points, slots, cnt_ok, queries, radius, k):
    """K12 against its plain version (``radius`` a float or f32[M])."""
    got = k12.knn_search(points, slots, cnt_ok, queries, radius, k)
    want = k12.knn_search_plain(points, slots, cnt_ok, queries, radius, k)
    torch.cuda.synchronize()
    _same(got.mask, want.mask, "knn_search mask")
    _same(got.points, want.points, "knn_search points")
    _same(got.dist, want.dist, "knn_search dist")
    return {"max_abs_err": 0.0, "found": int(want.mask.sum())}


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


def check_grid_sample(points, valid, voxel_size, capacity, table_log2=22):
    got = k4.grid_sample(points, valid, voxel_size, capacity, table_log2)
    want = k4.grid_sample_plain(points, valid, voxel_size, capacity,
                                table_log2)
    torch.cuda.synchronize()
    for a, b, name in zip(got, want, ("idx", "out_valid", "count")):
        _same(a, b, f"grid_sample {name}")
    return {"max_abs_err": 0.0, "count": int(want[2])}


def check_exact_sample(points, valid, capacity, **kw):
    """K13 against its plain version (``kw``: voxel_size or bands, k,
    max_keep): indices, mask and count identical."""
    got = k13.exact_sample(points, valid, capacity, **kw)
    want = k13.exact_sample_plain(points, valid, capacity, **kw)
    torch.cuda.synchronize()
    for a, b, name in zip(got, want, ("idx", "out_valid", "count")):
        _same(a, b, f"exact_sample {name}")
    return {"max_abs_err": 0.0, "count": int(want[2])}


def check_row_gather(table, slots, sub=None):
    got = k6.row_gather(table, slots, sub)
    want = k6.row_gather_plain(table, slots, sub)
    torch.cuda.synchronize()
    _same(got, want, "row_gather")
    return {"max_abs_err": 0.0}


def check_row_gather_fields(tables, slots, subs=None):
    """The one-launch gather of several tables against one
    ``row_gather_plain`` a field."""
    outs = k6.row_gather_fields(tables, slots, subs)
    want = k6.row_gather_fields_plain(tables, slots, subs)
    torch.cuda.synchronize()
    for f, (a, b) in enumerate(zip(outs, want)):
        _same(a, b, f"row_gather_fields field {f}")
    return {"max_abs_err": 0.0}


def plain_rebuild_level(level, shift, resolution):
    """rebuild_level through the plain versions of K7 and K6, a field at a
    time, and the sum of the moved counts."""
    table, src, _ = k7.rebuild_claim_plain(level.keys, level.count,
                                           level.points, shift, resolution)
    p = level.max_points
    count = k6.row_gather_plain(level.count[:, None], src)[:, 0]
    return vm.MapLevel(
        keys=table, count=count,
        points=k6.row_gather_plain(level.points, src,
                                   shift.repeat_interleave(p)),
        normals=k6.row_gather_plain(level.normals, src),
        nflags=k6.row_gather_plain(level.nflags[:, None], src)[:, 0],
        num_points=count.sum(dtype=torch.int32).reshape(1))


def check_rebuild_level(level, shift, resolution):
    """K7 against its plain version, then the whole ``rebuild_level``
    (K7 + one K6 over the four fields) against the plain one. Returns the
    rows kept and the claim rounds K7 ran too."""
    rounds = k7.rounds_counter(level.keys.device)
    before = int(rounds[0])
    got = k7.rebuild_claim(level.keys, level.count, level.points, shift,
                           resolution)
    want = k7.rebuild_claim_plain(level.keys, level.count, level.points,
                                  shift, resolution)
    torch.cuda.synchronize()
    _same(got[0], want[0], "rebuild_claim table")
    _same(got[1], want[1], "rebuild_claim src")
    _same(got[2], want[2], "rebuild_claim num_points")
    ran = int(rounds[0]) - before
    if not 0 <= ran <= k3.MAX_PROBES:
        raise AssertionError(f"rebuild_claim ran {ran} claim rounds")
    new = vm.rebuild_level(level, shift, resolution)
    ref = plain_rebuild_level(level, shift, resolution)
    torch.cuda.synchronize()
    for name in vm.MapLevel._fields:
        _same(getattr(new, name), getattr(ref, name), f"rebuild_level {name}")
    return {"max_abs_err": 0.0, "rows": int((want[1] >= 0).sum()),
            "num_points": int(ref.num_points[0]), "claim_rounds": ran}


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_lm_step(rows, prior, n_res, state, sigma, tolerant_a,
                  freeze_begin=False, loop_steps=0,
                  loss=LeastSquares.CAUCHY, family=k5.Family.PLANE,
                  use_distribution=True, analytic=False):
    """One K5 step and one plain step from copies of ``state``; then, with
    ``loop_steps``, one ``lm_loop`` call of that many steps against
    ``lm_loop_plain`` from ``state`` (each stops at done), with the steps
    each ran. ``family``, ``use_distribution`` and ``analytic`` as
    ``lm_loop`` takes them; ``prior`` f32[14] or f32[41]."""
    args = (loss, sigma, tolerant_a, freeze_begin, family, use_distribution,
            analytic)
    a, b = state.clone(), state.clone()
    k5.lm_loop(rows, prior, n_res, a, 1, *args)
    k5.lm_step_plain(rows, prior, n_res, b, *args)
    torch.cuda.synchronize()
    jtj = slice(k5.S_JTJ, k5.S_JTJ + 144)
    jtr = slice(k5.S_JTR, k5.S_JTR + 12)
    delta = slice(k5.S_DELTA, k5.S_DELTA + 12)
    errs = {"jtj": _rel_err(a[jtj], b[jtj]), "jtr": _rel_err(a[jtr], b[jtr]),
            "delta": _rel_err(a[delta], b[delta]),
            "cost1": _rel_err(a[k5.S_COST1], b[k5.S_COST1]),
            "cost0": _rel_err(a[k5.S_COST0], b[k5.S_COST0])}
    limits = {"jtj": 1e-4, "jtr": 1e-4, "delta": 1e-3, "cost1": 1e-5,
              "cost0": 1e-5}
    for name, lim in limits.items():
        if not errs[name] <= lim:
            raise AssertionError(f"lm_step {name}: relative error "
                                 f"{errs[name]:.3g} > {lim}")
    out = {"max_abs_err": float(max((a[s] - b[s]).abs().max()
                                    for s in (jtj, jtr, delta))),
           "relative": errs}
    if loop_steps:
        a, b = state.clone(), state.clone()
        counter = k5.steps_counter(rows.device)
        before = int(counter[0])
        k5.lm_loop(rows, prior, n_res, a, loop_steps, *args)
        torch.cuda.synchronize()
        steps = int(counter[0]) - before
        plain_steps = k5.lm_loop_plain(rows, prior, n_res, b, loop_steps,
                                       *args)
        pa, pb = a[0:14].double().cpu().numpy(), b[0:14].double().cpu().numpy()
        d_tr = max(np.linalg.norm(pa[4:7] - pb[4:7]),
                   np.linalg.norm(pa[11:14] - pb[11:14]))
        d_rot = max(s3n.angular_distance_deg(pa[0:4], pb[0:4]),
                    s3n.angular_distance_deg(pa[7:11], pb[7:11]))
        if not (d_tr <= 1e-3 and d_rot <= 1e-2):
            raise AssertionError(f"lm_loop: poses {d_tr:.3g} m, "
                                 f"{d_rot:.3g} deg apart")
        if not 1 <= steps <= loop_steps:
            raise AssertionError(f"lm_loop ran {steps} of {loop_steps} steps")
        out["loop"] = {"steps": loop_steps, "steps_run": steps,
                       "plain_steps_run": plain_steps,
                       "d_tr_m": float(d_tr), "d_rot_deg": float(d_rot),
                       "done": (float(a[k5.S_DONE]), float(b[k5.S_DONE]))}
    return out


def check_ct_ba_block(poses, problem, beta, damping, mode,
                      compare_poses=True, iters=1, halo=None):
    """K8 against ``ct_ba_block_plain`` on the same window, and a second
    launch against the first. With ``iters`` inner iterations (mode "gn")
    the last iteration's J^T J, costs and update are held to the plain
    version's one iteration from the same poses, the kernel's own iterate
    before it (``iters - 1`` iterations in one launch), and the final poses
    also to the plain version's ``iters`` iterations; J^T r is held after
    one iteration, and after several against the plain version in float64
    (see below why not the float32 one). Returns
    the errors and, in mode "gn", the largest pose differences
    (``compare_poses=False`` leaves the updated poses to the two-launch
    check alone: for a system too ill-conditioned for two solves to
    agree)."""
    a = k8.ct_ba_block(poses, problem, beta, damping, mode, iters, halo)
    again = k8.ct_ba_block(poses, problem, beta, damping, mode, iters, halo)
    start = poses if iters == 1 else k8.ct_ba_block(
        poses, problem, beta, damping, mode, iters - 1).poses
    b = k8.ct_ba_block_plain(start, problem, beta, damping, mode, 1, halo)
    torch.cuda.synchronize()
    for x, y, what in ((a.jtj, again.jtj, "J^T J"), (a.jtr, again.jtr,
                                                     "J^T r"),
                       (a.cost, again.cost, "cost"),
                       (a.total, again.total, "total")):
        _same(x, y, f"ct_ba_block {mode} {what}, two launches")

    def rel(x, y):
        return float(((x - y).abs() / torch.clamp_min(y.abs(), 1e-7)).max())

    # after several iterations J^T r is the gradient of a nearly converged
    # window: residuals of a few mm from world points of ~10 m, whose
    # float32 rounding alone moves it by 1e-4 to 1e-3 of the size of its
    # terms (the sum over rows of |J| |r|; the plain version in float32
    # against float64 at the same poses, 70,000 rows). There it is reported
    # against that size, and the update it drives is held through the poses
    jtr_scale = b.jtr.abs().max() if iters == 1 else _jtr_terms(
        start, problem, beta, mode).max()
    errs = {"jtj": _rel_err(a.jtj, b.jtj),
            "jtr": float((a.jtr - b.jtr).abs().max()
                         / jtr_scale.clamp_min(1e-30)),
            "cost": rel(a.cost, b.cost), "total": rel(a.total, b.total)}
    limits = {"jtj": 1e-4, "cost": 1e-5, "total": 1e-5}
    if iters == 1:
        limits["jtr"] = 1e-4
    for name, lim in limits.items():
        if not errs[name] <= lim:
            raise AssertionError(f"ct_ba_block {mode} x{iters} {name}: "
                                 f"relative error {errs[name]:.3g} > {lim}")
    out = {"max_abs_err": float(max((a.jtj - b.jtj).abs().max(),
                                    (a.jtr - b.jtr).abs().max(),
                                    (a.cost - b.cost).abs().max())),
           "relative": errs}
    if iters > 1:
        # the last iteration's J^T r against the same iteration in float64
        # from the kernel's iterate n - 1: the kernel no further from it
        # than the float32 plain version's rounding allows
        p64 = ba.CTBAProblem(*(x.double() for x in problem))
        jtr_64 = k8.ct_ba_block_plain(start.double(), p64, beta, damping,
                                      mode, 1).jtr
        gaps = {"kernel_vs_float64": _rel_err(a.jtr.double(), jtr_64),
                "plain_vs_float64": _rel_err(b.jtr.double(), jtr_64)}
        if not gaps["kernel_vs_float64"] <= max(
                10 * gaps["plain_vs_float64"], 1e-6):
            raise AssertionError(f"ct_ba_block {mode} x{iters}: J^T r off "
                                 f"the float64 plain version: {gaps}")
        out["jtr_float64"] = gaps
    if mode == "gn":
        _same(a.poses, again.poses, "ct_ba_block gn poses, two launches")
    if mode == "gn" and compare_poses:
        whole = b if iters == 1 else k8.ct_ba_block_plain(
            poses, problem, beta, damping, mode, iters)
        gaps = [_pose_gap(a.poses, y.poses) for y in (b, whole)]
        d_tr = max(g[0] for g in gaps)
        d_rot = max(g[1] for g in gaps)
        if not (d_tr <= 1e-5 and d_rot <= 1e-4):
            raise AssertionError(f"ct_ba_block gn x{iters}: poses {d_tr:.3g} "
                                 f"m, {d_rot:.3g} deg apart")
        out.update(d_tr_m=d_tr, d_rot_deg=d_rot)
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((a.poses - b.poses).abs().max()))
    return out


def _jtr_terms(poses, problem, beta, mode):
    """Each frame's sum over its rows of |J| |r| ([F, 12]): the scale of
    J^T r's terms (the plain row pass, ``parallel/ct_ba.py::frame_system``)."""
    r0, jac = ba.frame_system(poses, problem, beta, continuity=mode == "gn")
    return (jac.abs() * r0.abs()[..., None]).sum(-2)


def _pose_gap(x, y):
    """The largest translation (m) and rotation (deg) difference of two
    [F, 14] pose sets."""
    pa, pb = x.double().cpu().numpy(), y.double().cpu().numpy()
    d_tr = float(max(np.abs(pa[:, 4:7] - pb[:, 4:7]).max(),
                     np.abs(pa[:, 11:14] - pb[:, 11:14]).max()))
    d_rot = float(max(max(s3n.angular_distance_deg(u[0:4], v[0:4]),
                          s3n.angular_distance_deg(u[7:11], v[7:11]))
                      for u, v in zip(pa, pb)))
    return d_tr, d_rot


def check_ct_ba_iterations(poses, problem, beta, damping, iters):
    """One K8 launch of ``iters`` inner iterations against ``iters``
    launches of one, each on the previous one's poses: identical poses,
    J^T J, J^T r, costs and total (the same arithmetic in the same
    order)."""
    one = k8.ct_ba_block(poses, problem, beta, damping, "gn", iters)
    p = poses
    for _ in range(iters):
        step = k8.ct_ba_block(p, problem, beta, damping, "gn", 1)
        p = step.poses
    torch.cuda.synchronize()
    for name in ("poses", "cost", "jtj", "jtr", "total"):
        _same(getattr(one, name), getattr(step, name),
              f"ct_ba_block {iters} iterations in one launch {name}")
    return {"max_abs_err": 0.0}


def check_evict_voxels(level, coords, valid):
    """Both versions evict from their own copy of ``level``'s keys, counts,
    flags and num_points; the copies and the points removed must be
    identical. Returns the points removed and the slots emptied too."""
    a = [t.clone() for t in (level.keys, level.count, level.nflags,
                             level.num_points)]
    b = [t.clone() for t in a]
    r_a = k9.evict_voxels(*a, coords, valid)
    r_b = k9.evict_voxels_plain(*b, coords, valid)
    torch.cuda.synchronize()
    for x, y, name in zip(a + [r_a], b + [r_b],
                          ("keys", "count", "nflags", "num_points",
                           "removed")):
        _same(x, y, f"evict_voxels {name}")
    emptied = int(((level.count > 0) & (a[1] == 0)).sum())
    return {"max_abs_err": 0.0, "removed": int(r_b[0]), "emptied": emptied}


def check_evict_levels(levels, coords, counts):
    """The one-launch eviction over every level against the plain one, each
    on its own copy of the levels' keys, counts, flags and num_points: the
    copies and the points removed (a level each, then the total)
    identical. Returns the points removed a level and in all."""
    copies = []
    for _ in range(2):
        copies.append([type(lv)(*(t.clone() for t in lv)) for lv in levels])
    r_a = k9.evict_levels(copies[0], coords, counts)
    r_b = k9.evict_levels_plain(copies[1], coords, counts)
    torch.cuda.synchronize()
    for li, (x, y) in enumerate(zip(*copies)):
        for name in ("keys", "count", "nflags", "num_points"):
            _same(getattr(x, name), getattr(y, name),
                  f"evict_levels level {li} {name}")
    _same(r_a, r_b, "evict_levels removed")
    return {"max_abs_err": 0.0, "removed": r_b.tolist()}


# K10's comparison: eigenvalue gap, orientation margin, normal tolerance
NORMALS_EIG_GAP = 5e-2
NORMALS_ORIENT_MARGIN_M = 1e-3
NORMALS_ATOL = 1e-4


def check_level_normals(level, location, slots):
    """K10 against its plain version on the listed ``slots`` of ``level``
    (see the module docstring). Returns the refit slots, the slots left out
    of the normal comparison, and the largest normal difference
    compared."""
    args = (level.keys, level.count, level.points, level.normals,
            level.nflags, location, slots)
    got_n, got_f = k10.level_normals(*args)
    want_n, want_f = k10.level_normals_plain(*args)
    torch.cuda.synchronize()
    _same(got_f, want_f, "level_normals nflags")
    listed = slots.long()
    refit = k10.refit_mask(level.keys[listed], level.count[listed])
    _same(got_f == k10.REFIT_FLAG, refit, "level_normals refit slots")
    _same(got_n[~refit], want_n[~refit], "level_normals kept normals")
    got_n, want_n = got_n[refit], want_n[refit]
    slots = listed[refit]
    p = level.max_points
    rows = level.points[slots].double().view(-1, 3, p)
    cnt = level.count[slots].clamp_max(p)
    mask = (torch.arange(p, device=rows.device)[None, :]
            < cnt[:, None]).double()[:, None, :]
    n = cnt.double()[:, None]
    mean = (rows * mask).sum(-1) / n
    dev = (rows - mean[:, :, None]) * mask
    cov = dev @ dev.transpose(1, 2) / n[:, :, None]
    w, v = torch.linalg.eigh(cov)                 # ascending
    apart = (w[:, 1] - w[:, 0]) > NORMALS_EIG_GAP * w[:, 2].clamp_min(1e-30)
    dot = ((mean - location.double()) * v[:, :, 0]).sum(-1)
    decided = dot.abs() > NORMALS_ORIENT_MARGIN_M
    a, b = got_n, want_n
    err = (a - b).abs().amax(-1)
    err = torch.where(decided, err, torch.minimum(err, (a + b).abs().amax(
        -1)))[apart]
    worst = float(err.max()) if err.numel() else 0.0
    if worst >= NORMALS_ATOL:
        raise AssertionError(f"level_normals: a normal differs by {worst}")
    return {"max_abs_err": worst, "refit": int(slots.shape[0]),
            "left_out": int((~apart).sum())}


def check_ct_ba_halo(poses, problem, halo, beta, damping):
    """K8's single-iteration "gn" launch with ``halo`` held as
    :func:`check_ct_ba_block` holds it, and its J^T r against the plain
    version in float64 from the same poses (ROADMAP's watch item on K8's
    J^T r): within 10 times the float32 plain version's gap (relative to
    the largest entry), or 1e-6."""
    out = check_ct_ba_block(poses, problem, beta, damping, "gn", halo=halo)
    a = k8.ct_ba_block(poses, problem, beta, damping, "gn", 1, halo)
    b = k8.ct_ba_block_plain(poses, problem, beta, damping, "gn", 1, halo)
    p64 = ba.CTBAProblem(*(x.double() for x in problem))
    jtr_64 = k8.ct_ba_block_plain(poses.double(), p64, beta, damping, "gn",
                                  1, halo.double()).jtr
    gaps = {"kernel_vs_float64": _rel_err(a.jtr.double(), jtr_64),
            "plain_vs_float64": _rel_err(b.jtr.double(), jtr_64)}
    if not gaps["kernel_vs_float64"] <= max(
            10 * gaps["plain_vs_float64"], 1e-6):
        raise AssertionError(f"ct_ba_block halo: J^T r off the float64 "
                             f"version {gaps}")
    out["jtr_float64"] = gaps
    return out


def check_owner_pack(world, valid, resolution, n, cap):
    """K11 against its plain version, and a second call against the
    first: identical."""
    got = k11.owner_pack(world, valid, resolution, n, cap)
    again = k11.owner_pack(world, valid, resolution, n, cap)
    want = k11.owner_pack_plain(world, valid, resolution, n, cap)
    torch.cuda.synchronize()
    for a, b, c, name in zip(got, again, want,
                             ("send", "send_valid", "dropped")):
        _same(a, b, f"owner_pack {name}, two calls")
        _same(a, c, f"owner_pack {name}")
    return {"max_abs_err": 0.0, "dropped": int(want.dropped[0]),
            "sent": int(want.send_valid.sum())}


def check_insert_with_normals(level, pts, valid, resolution, min_dist,
                              max_rounds, begin_tr, max_dirty):
    """K3 with its rank-0 slots against the plain version, each on its own
    copy of ``level`` (every field and the slots identical), then the
    dirty list (the rank-0 slots in scan order, the first ``max_dirty``)
    refit by K10 against its plain version (:func:`check_level_normals`)
    on the kernel's copy. Returns the dirty slots and the refit's
    errors."""
    a = [t.clone() for t in (level.keys, level.count, level.points,
                             level.num_points)]
    b = [t.clone() for t in a]
    n_a, r_a = k3.map_insert(*a, pts, valid, resolution, min_dist,
                             max_rounds, rank0=True)
    n_b, r_b = k3.map_insert_plain(*b, pts, valid, resolution, min_dist,
                                   max_rounds, rank0=True)
    torch.cuda.synchronize()
    for x, y, name in zip(a + [n_a, r_a], b + [n_b, r_b],
                          ("keys", "count", "points", "num_points",
                           "inserted", "rank-0 slots")):
        _same(x, y, f"map_insert {name}")
    dirty = r_a[torch.nonzero(r_a >= 0)[:, 0]][:max_dirty]
    after = level._replace(keys=a[0], count=a[1], points=a[2],
                           num_points=a[3])
    out = check_level_normals(after, begin_tr, dirty)
    out.update(dirty=int(dirty.shape[0]), inserted=int(n_a[0]))
    return out


def check_scan_unpack(packed):
    """K14's unpack against its plain version: identical."""
    got = k14.unpack(packed)
    want = k14.unpack_plain(packed)
    torch.cuda.synchronize()
    _same(got[0], want[0], "scan_transform unpack xyz")
    _same(got[1], want[1], "scan_transform unpack alphas")
    return {"max_abs_err": 0.0}


def check_scan_transform(raw, alphas, qb, tb, qe, te, distort=False):
    """K14's transform (``distort``: distort_raw) against its plain
    version: identical."""
    got = k14.transform(raw, alphas, qb, tb, qe, te, distort)
    want = k14.transform_plain(raw, alphas, qb, tb, qe, te, distort)
    torch.cuda.synchronize()
    _same(got, want, f"scan_transform (distort={distort})")
    return {"max_abs_err": 0.0, "coords": int(got.numel())}


def check_prune_levels(levels, location, max_distance, gate=None):
    """The one-launch prune of every level against the plain one, each on
    its own copy of the levels: keys, counts, flags and num_points
    identical. Returns the voxels and points removed a level."""
    copies = [[type(lv)(*(t.clone() for t in lv)) for lv in levels]
              for _ in range(2)]
    k15.prune_levels(copies[0], location, max_distance, gate)
    k15.prune_levels_plain(copies[1], location, max_distance, gate)
    torch.cuda.synchronize()
    for li, (x, y) in enumerate(zip(*copies)):
        for name in ("keys", "count", "nflags", "num_points"):
            _same(getattr(x, name), getattr(y, name),
                  f"prune_levels level {li} {name}")
    return {"max_abs_err": 0.0,
            "tombstoned": [int(((lv.keys != k15.TOMB) & (c.keys == k15.TOMB))
                               .sum()) for lv, c in zip(levels, copies[0])],
            "removed": [int(lv.num_points[0] - c.num_points[0])
                        for lv, c in zip(levels, copies[0])]}


def check_compact_mask(mask, capacity):
    """K16 against its plain version: indices, count and validity
    identical."""
    got = k16.compact_mask(mask, capacity)
    want = k16.compact_mask_plain(mask, capacity)
    torch.cuda.synchronize()
    for a, b, name in zip(got, want, ("idx", "count", "out_valid")):
        _same(a, b, f"compact_mask {name}")
    return {"max_abs_err": 0.0, "count": int(want[1])}


def check_knn_describe(points, slots, cnt_ok, queries, radius, k,
                       full=False):
    """K17 against its plain version (K12's plain search, then
    ``compute_description``): the list identical, the descriptor within
    K2's tolerances (the module docstring)."""
    (nb, got) = k12.knn_describe(points, slots, cnt_ok, queries, radius, k,
                                 full)
    want_nb, want = k12.knn_describe_plain(points, slots, cnt_ok, queries,
                                           radius, k, full)
    torch.cuda.synchronize()
    _same(nb.mask, want_nb.mask, "knn_describe mask")
    _same(nb.points, want_nb.points, "knn_describe points")
    _same(nb.dist, want_nb.dist, "knn_describe dist")
    count = want_nb.mask.sum(-1)
    # the query's second-moment sums (the scale K2's check holds its sums
    # to): the plain version's
    rel = ((want_nb.points - queries[:, None, :])
           * want_nb.mask[..., None].to(queries.dtype))
    scale = (rel[..., :, None] * rel[..., None, :]).sum(1).abs() \
        .amax(dim=(1, 2)) + 1e-6
    planar = (count >= 10) & (want.a2D > 0.5)
    cosang = (got.normal * want.normal).sum(-1).abs()
    if planar.any() and (1.0 - cosang[planar]).max() > 1e-3:
        raise AssertionError("knn_describe normal beyond 1e-3")
    five = count >= 5
    a2d_err = (got.a2D[five] - want.a2D[five]).abs()
    if five.any() and a2d_err.max() > 1e-3:
        raise AssertionError(f"knn_describe a2D: {a2d_err.max().item()}")
    out = {"max_abs_err": max(
        (1.0 - cosang[planar]).max().item() if planar.any() else 0.0,
        a2d_err.max().item() if five.any() else 0.0),
        "found": int(count.sum()), "planar": int(planar.sum())}
    if full:
        out.update(_check_descriptor(got, want, queries, scale, five,
                                     "knn_describe"))
    return out
