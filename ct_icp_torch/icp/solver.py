"""The continuous-time ICP solver (torch, eager).

Counterpart of ``ct_icp_tpu/icp/solver.py`` on the ball-neighborhood CERES
path the driving profile runs:

    outer loop (<= num_iters_icp, early exit on pose deltas):
      1. transform keypoints by the slerp/lerp-interpolated poses
      2. candidate rows: a fresh gather (kernel K1) on regather iterations —
         the first ``regather_iters``, or when the pose moved more than half
         a voxel (translation or rotation) since the last gather — else the
         cached rows
      3. moments + descriptor (kernel K2), the k-NN shell radius cached with
         the rows and recomputed only on regather iterations
      4. geometric weights, the uniform-stride residual cap
      5. LM inner loop (<= ls_max_num_iters): Jacobian by forward mode
         through the slerp (torch.func.jacfwd, as jax.jacfwd), IRLS weights,
         the Jacobi-preconditioned damped 12x12 solve with the degenerate-
         column freeze, accept/reject, the function-tolerance exit
      6. convergence test on rot/trans deltas

The reference runs this as one XLA program; here it is a Python loop, so
each early exit (LM done, outer convergence + the next regather decision)
is a device->host read: ``RegistrationResult.host_syncs`` counts them.
Dynamic scalars are numpy float32 values, so derived thresholds round as
the reference's float32 arithmetic does.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from ct_icp_torch.config.options import (CTICPOptions, IcpDistance,
                                         LeastSquares, PoseParametrization,
                                         Solver)
from ct_icp_torch.core import se3 as s3
from ct_icp_torch.icp import residuals as res
from ct_icp_torch.mapping import voxel_map as vm

MAX_OUTER_ITERS = 64
MAX_INNER_ITERS = 64


@dataclasses.dataclass(frozen=True)
class SolverStatics:
    """Static part of the registration configuration (the reference's
    compile-time specialization; here it selects code paths)."""

    num_keypoints: int            # K capacity
    max_neighbors: int
    level_index: int              # which map resolution level is searched
    voxel_neighborhood: int       # nv: (2nv+1)^3 voxels scanned
    distance: IcpDistance = IcpDistance.POINT_TO_PLANE
    loss: LeastSquares = LeastSquares.CAUCHY
    solver: Solver = Solver.CERES
    parametrization: PoseParametrization = PoseParametrization.CONTINUOUS_TIME
    num_closest_neighbors: int = 1
    use_normal_filter: bool = False
    use_distance_strategy: bool = False
    ball_neighborhood: bool = True
    knn_moments: bool = True
    max_candidate_voxels: int = 0
    analytic_jacobian: bool = False


class SolverDynamics(NamedTuple):
    """Dynamic scalars (the reference's packed vector, same field order)."""

    num_iters_icp: int
    ls_max_num_iters: int
    ls_sigma: np.float32
    ls_tolerant_min_threshold: np.float32
    max_dist_to_plane: np.float32
    threshold_orientation_norm: np.float32  # degrees
    threshold_translation_norm: np.float32  # meters
    search_radius: np.float32
    voxel_resolution: np.float32
    min_number_neighbors: int
    power_planarity: np.float32
    weight_alpha: np.float32
    weight_neighborhood: np.float32
    threshold_voxel_occupancy: int
    max_num_residuals: int                  # <= 0 disables the cap
    threshold_linearity: np.float32
    threshold_planarity: np.float32
    weight_point_to_point: np.float32
    outlier_distance: np.float32
    radius_min: np.float32
    radius_max: np.float32
    radius_exponent: np.float32
    regather_iters: int
    max_number_neighbors: int


_INT_FIELDS = {"num_iters_icp", "ls_max_num_iters", "min_number_neighbors",
               "threshold_voxel_occupancy", "max_num_residuals",
               "regather_iters", "max_number_neighbors"}


def pack_dynamics(opts: CTICPOptions, search_radius, voxel_resolution,
                  distance_strategy=None) -> np.ndarray:
    """All dynamic scalars in one float32 vector (the reference layout)."""
    ds = distance_strategy
    vals = [
        opts.num_iters_icp, opts.ls_max_num_iters, opts.ls_sigma,
        opts.ls_tolerant_min_threshold, opts.max_dist_to_plane_ct_icp,
        opts.threshold_orientation_norm, opts.threshold_translation_norm,
        search_radius, voxel_resolution, opts.min_number_neighbors,
        opts.power_planarity, opts.weight_alpha, opts.weight_neighborhood,
        opts.threshold_voxel_occupancy, opts.max_num_residuals,
        opts.threshold_linearity, opts.threshold_planarity,
        opts.weight_point_to_point, opts.outlier_distance,
        ds.radius_min if ds else 0.0,
        ds.radius_max if ds else 0.0,
        ds.exponent if ds else 1.0,
        opts.regather_iters,
        opts.max_number_neighbors,
    ]
    return np.asarray(vals, dtype=np.float32)


def unpack_dynamics(packed) -> SolverDynamics:
    """Packed vector -> SolverDynamics (ints as int, the rest float32)."""
    packed = np.asarray(packed, np.float32)
    return SolverDynamics(**{
        name: (int(packed[i]) if name in _INT_FIELDS else packed[i])
        for i, name in enumerate(SolverDynamics._fields)})


class RegistrationResult(NamedTuple):
    quat_begin: torch.Tensor
    tr_begin: torch.Tensor
    quat_end: torch.Tensor
    tr_end: torch.Tensor
    num_residuals: torch.Tensor    # residuals used in the last iteration
    num_iters: int
    converged: bool
    final_cost: torch.Tensor
    valid_problem: bool            # enough residuals were found
    host_syncs: int                # device->host reads the loops made


def _build_problem(statics, dyn, level, raw, alphas, valid, qb, tb, qe, te,
                   cache, do_gather: bool):
    """Association + descriptors at the current pose estimate.

    ``cache`` = (rows, cnt_ok, r_eff2) of the last gather, reused when
    ``do_gather`` is False. Returns (anchors, normals, geom_w, ok, cache)."""
    world = res.interp_world_points(qb, tb, qe, te, raw, alphas)
    k_nearest = dyn.max_number_neighbors if statics.knn_moments else None
    if do_gather:
        rows, cnt_ok = vm.gather_candidate_planes(
            level, world, valid, dyn.voxel_resolution,
            statics.voxel_neighborhood, dyn.threshold_voxel_occupancy)
        cached_r = None
    else:
        rows, cnt_ok, cached_r = cache
    mom = vm.moments_from_planes(rows, cnt_ok, world, dyn.search_radius,
                                 k_nearest=k_nearest, cached_r_eff2=cached_r)
    ok = valid & (mom.count >= dyn.min_number_neighbors)
    closest_dist = torch.where(torch.isfinite(mom.closest_dist),
                               mom.closest_dist,
                               torch.zeros_like(mom.closest_dist))
    geom_w = res.ceres_path_weights(
        mom.a2d, closest_dist, dyn.power_planarity, dyn.weight_alpha,
        dyn.weight_neighborhood, dyn.max_dist_to_plane,
        np.float32(max(dyn.min_number_neighbors, 1)))

    # cap the residuals by a uniform stride over the valid points (the
    # reference caps a shuffled order; keypoints arrive voxel-sorted)
    ok_i = ok.to(torch.int64)
    n_ok = torch.clamp_min(ok_i.sum(), 1)
    cap = dyn.max_num_residuals if dyn.max_num_residuals > 0 else 1 << 30
    rank = torch.cumsum(ok_i, 0) - 1
    cap_c = torch.clamp_max(n_ok, cap)
    sel = (torch.div(rank * cap_c, n_ok, rounding_mode="floor")
           != torch.div((rank - 1) * cap_c, n_ok, rounding_mode="floor"))
    ok = ok & (sel | (n_ok <= cap))
    return mom.closest, mom.normal, geom_w, ok, (rows, cnt_ok, mom.r_eff2)


def _lm_inner_loop(statics, dyn, raw, alphas, anchors, normals, geom_w, ok,
                   qb, tb, qe, te, prior):
    """ceres::Solve replacement: <= ls_max_num_iters damped-GN steps with
    IRLS weights and accept/reject damping. Returns (qb, tb, qe, te, cost,
    n_res, host_syncs)."""
    k = raw.shape[0]
    n_res = ok.to(torch.int32).sum()
    dev = raw.device
    freeze_begin = statics.parametrization == PoseParametrization.SIMPLE

    def residual_vector(delta, q0, t0, q1, t1):
        q0b, t0b, q1b, t1b = res.apply_delta(delta, q0, t0, q1, t1)
        world = res.interp_world_points(q0b, t0b, q1b, t1b, raw, alphas)
        geo = res.geometric_residuals(statics.distance, world, anchors,
                                      normals, geom_w)
        geo = torch.where(ok[:, None], geo, torch.zeros_like(geo)).reshape(-1)
        pri = res.motion_prior_residuals(q0b, t0b, q1b, t1b, prior, n_res)
        return torch.cat([geo, pri])

    def total_cost(delta, q0, t0, q1, t1):
        r = residual_vector(delta, q0, t0, q1, t1)
        pr, prior_r = r[:k], r[k:]
        c_pts = torch.sum(res.robust_cost(statics.loss, pr * pr, dyn.ls_sigma,
                                          dyn.ls_tolerant_min_threshold))
        return c_pts + torch.sum(prior_r * prior_r)

    zero = torch.zeros(12, dtype=raw.dtype, device=dev)
    eye = torch.eye(12, dtype=raw.dtype, device=dev)
    lam = torch.tensor(1e-4, dtype=raw.dtype, device=dev)
    cost0 = total_cost(zero, qb, tb, qe, te)
    syncs = 0
    for _ in range(min(dyn.ls_max_num_iters, MAX_INNER_ITERS)):
        def rfun(d, q0=qb, t0=tb, q1=qe, t1=te):
            return residual_vector(d, q0, t0, q1, t1)

        r0 = rfun(zero)
        jac = jacfwd(rfun)(zero)                       # [rows, 12]
        pr = r0[:k]
        w_pts = res.irls_weight(statics.loss, pr * pr, dyn.ls_sigma,
                                dyn.ls_tolerant_min_threshold)
        w = torch.cat([w_pts, torch.ones(r0.shape[0] - k, dtype=raw.dtype,
                                         device=dev)])
        if freeze_begin:
            jac = torch.cat([torch.zeros_like(jac[:, 0:6]), jac[:, 6:]], 1)
        jw = jac * w[:, None]
        jtj = jw.T @ jac
        jtr = jw.T @ r0
        diag = torch.diagonal(jtj)
        # freeze unobservable dimensions (e.g. the begin pose when every
        # alpha is 1 on the first frames): Jacobi scaling would otherwise
        # hide the rank deficiency and amplify float32 noise
        degen = diag <= 1e-7 * torch.clamp_min(diag.max(), 1e-12)
        keep = (~degen).to(raw.dtype)
        d = torch.where(degen, torch.ones_like(diag),
                        torch.sqrt(torch.clamp_min(diag, 1e-20)))
        a = jtj / (d[:, None] * d[None, :])
        a = a * keep[:, None] * keep[None, :] + torch.diag(degen.to(raw.dtype))
        a = a + lam * torch.diag(torch.diagonal(a)) + 1e-7 * eye
        b = -jtr / d * keep
        delta = torch.linalg.solve(a, b) / d * keep

        cost1 = total_cost(delta, qb, tb, qe, te)
        accept = cost1 < cost0
        # ceres::Solve's function_tolerance exit (Ceres default 1e-6)
        done = accept & (cost0 - cost1 <= 1e-6 * (cost0 + 1e-30))
        qb, tb, qe, te = res.apply_delta(
            torch.where(accept, delta, zero), qb, tb, qe, te)
        lam = torch.where(accept, torch.clamp_min(lam / 3.0, 1e-8),
                          torch.clamp_max(lam * 4.0, 1e4))
        cost0 = torch.where(accept, cost1, cost0)
        syncs += 1
        if bool(done):
            break
    return qb, tb, qe, te, cost0, n_res, syncs


def build_register_fn(statics: SolverStatics):
    """The registration loop for ``statics``:
      (level, raw [K,3], alphas [K], valid [K], qb, tb, qe, te, prior [14],
       dyn) -> RegistrationResult
    with ``dyn`` a SolverDynamics or its packed vector."""
    if (statics.solver != Solver.CERES or not statics.ball_neighborhood
            or statics.distance != IcpDistance.POINT_TO_PLANE
            or statics.num_closest_neighbors > 1
            or statics.use_distance_strategy or statics.use_normal_filter
            or statics.max_candidate_voxels > 0
            or statics.analytic_jacobian):
        raise NotImplementedError(
            "ct_icp_torch ports the ball-neighborhood CERES point-to-plane "
            f"path only; got {statics}")

    def register(level, raw, alphas, valid, qb, tb, qe, te, prior, dyn):
        if not isinstance(dyn, SolverDynamics):
            dyn = unpack_dynamics(dyn)
        qb = s3.quat_normalize(qb)
        qe = s3.quat_normalize(qe)
        half_voxel = np.float32(0.5) * dyn.voxel_resolution
        # farthest keypoint distance: turns a rotation since the last
        # gather into its worst-case point displacement
        r_max = torch.where(valid, torch.linalg.norm(raw, dim=-1),
                            torch.zeros_like(raw[:, 0])).max()
        anchor_tr, anchor_qe, anchor_qb = te, qe, qb
        cost = torch.tensor(float("inf"), device=raw.device)
        n_res = torch.zeros((), dtype=torch.int32, device=raw.device)
        enough, converged = True, False
        cache, do_gather = None, True
        syncs = 0
        it = 0
        # iteration 0 is the reference's peeled iteration: its gather is
        # unconditional and creates the cache the later iterations reuse
        while it < min(dyn.num_iters_icp, MAX_OUTER_ITERS) and not converged:
            if do_gather:
                anchor_tr, anchor_qe, anchor_qb = te, qe, qb
            anchors, normals, geom_w, ok, cache = _build_problem(
                statics, dyn, level, raw, alphas, valid, qb, tb, qe, te,
                cache, do_gather)
            nqb, ntb, nqe, nte, cost, n_res, lm_syncs = _lm_inner_loop(
                statics, dyn, raw, alphas, anchors, normals, geom_w, ok,
                qb, tb, qe, te, prior)
            syncs += lm_syncs
            # not enough residuals: freeze the state, fail the problem
            enough_t = n_res >= dyn.min_number_neighbors
            nqb = torch.where(enough_t, nqb, qb)
            ntb = torch.where(enough_t, ntb, tb)
            nqe = torch.where(enough_t, nqe, qe)
            nte = torch.where(enough_t, nte, te)
            diff_rot = (s3.angular_distance_deg(qb, nqb)
                        + s3.angular_distance_deg(qe, nqe))
            diff_trans = (torch.linalg.norm(tb - ntb)
                          + torch.linalg.norm(te - nte))
            conv_t = ((diff_rot < dyn.threshold_orientation_norm)
                      & (diff_trans < dyn.threshold_translation_norm)) \
                | ~enough_t
            qb, tb, qe, te = nqb, ntb, nqe, nte
            it += 1
            # the next iteration regathers when the pose moved more than
            # half a voxel since the cached gather, by translation or by
            # rotation (a keypoint at r_max moves ~r_max * dtheta)
            moved_tr = torch.linalg.norm(te - anchor_tr) > half_voxel
            dtheta = torch.maximum(
                s3.angular_distance_deg(qe, anchor_qe),
                s3.angular_distance_deg(qb, anchor_qb)) * (np.pi / 180.0)
            moved_rot = dtheta * r_max > half_voxel
            flags = torch.stack([conv_t, enough_t, moved_tr | moved_rot]
                                ).tolist()
            syncs += 1
            converged, enough = flags[0], flags[1]
            do_gather = (it < dyn.regather_iters) or flags[2]

        return RegistrationResult(
            quat_begin=s3.quat_normalize(qb), tr_begin=tb,
            quat_end=s3.quat_normalize(qe), tr_end=te,
            num_residuals=n_res, num_iters=it, converged=converged,
            final_cost=cost, valid_problem=enough, host_syncs=syncs)

    return register
