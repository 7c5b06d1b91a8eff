"""The continuous-time ICP solver (torch, eager).

Counterpart of ``ct_icp_tpu/icp/solver.py`` on the CERES point-to-plane
path, with either neighbourhood and either search radius:

    outer loop (<= num_iters_icp, early exit on pose deltas):
      1. transform keypoints by the slerp/lerp-interpolated poses
      2. ball neighbourhood (the default): candidate voxels by a fresh
         gather (kernel K1) on regather iterations — the first
         ``regather_iters``, or when the pose moved more than half a voxel
         (translation or rotation) since the last gather — else the cached
         slots; then the moments + descriptor (kernel K2) of the map points
         the slots name, the k-NN shell radius cached with the slots and
         recomputed only on regather iterations.
         Exact k-NN (``ball_neighborhood=False``, the reference C++'s
         search): K1 over all voxels and the k nearest in-radius points
         (kernel K12) each iteration, no cache, the descriptor of the
         masked neighbour list; with num_closest_neighbors = kc > 1, kc
         residual rows a keypoint anchored at its kc nearest.
         The radius is the search radius, or with the distance strategy
         one a keypoint growing with its range; that strategy also turns
         on K1's normal filter, seen from the initial end translation
      4. geometric weights, the uniform-stride residual cap
      5. LM inner loop: up to min(ls_max_num_iters, 64) steps in one call
         of kernel K5: Jacobian by forward mode through the slerp (as
         jax.jacfwd), IRLS weights, the Jacobi-preconditioned damped 12x12
         solve with the degenerate-column freeze, accept/reject; the loop
         ends at the function-tolerance exit, on the device
      6. convergence test on rot/trans deltas

The cache holds map slots, not a copy of the candidate rows as the
reference's does, so it stays valid only while the level is not written
between a gather and the rescorings that reuse it. No path writes it: the
cache lives inside one ``register`` call, which starts with the
unconditional gather of the peeled iteration 0, and every insert, prune and
rebase comes after a registration returns, in stream order on the device —
in ``register_frame(_prepared)`` (each robust attempt is its own
registration; the robust-gated insert and the deferred map update follow
the accepted one), in ``_stream_frames_batched`` (each frame registers,
then prunes and inserts), in ``_stream_frames_robust`` (a rollback restores
the checkpoint and a replay re-registers, both between registrations) and
in the rebases (``_maybe_rebase``, ``_rebase_stream_head`` and the
streamer's deferred rebases, after the frame's update).

The reference runs this as one XLA program; here the outer loop is a Python
loop, so its early exit (outer convergence + the next regather decision) is
one device->host read per ICP iteration: ``RegistrationResult.host_syncs``
counts them. The LM call reads nothing back.
Dynamic scalars are numpy float32 values, so derived thresholds round as
the reference's float32 arithmetic does.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ct_icp_torch.config.options import (CTICPOptions, IcpDistance,
                                         LeastSquares, PoseParametrization,
                                         Solver)
from ct_icp_torch.core import se3 as s3
from ct_icp_torch.icp import residuals as res
from ct_icp_torch.kernels import lm_step as lm
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.ops.neighborhood import compute_description

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


def search_radius(statics, dyn, raw):
    """The search radius: ``dyn.search_radius``, or with the distance
    strategy one a keypoint, growing with its range (reference
    :231-239, neighborhood_strategy.h:124-129, the clamp by radius_max
    kept): a * r_max + (1 - a) * r_min, a = (min(|raw|, r_max) / r_max)^e."""
    if not statics.use_distance_strategy:
        return dyn.search_radius
    d_sensor = torch.sqrt(raw[:, 0] * raw[:, 0] + raw[:, 1] * raw[:, 1]
                          + raw[:, 2] * raw[:, 2])
    r_max, r_min = float(dyn.radius_max), float(dyn.radius_min)
    a = torch.pow(torch.clamp_max(d_sensor, r_max)
                  / float(np.maximum(dyn.radius_max, np.float32(1e-9))),
                  float(dyn.radius_exponent))
    return (a * r_max + (1.0 - a) * r_min).contiguous()


def _build_problem(statics, dyn, level, raw, alphas, valid, qb, tb, qe, te,
                   radius, sensor_location, cache, do_gather: bool):
    """Association + descriptors at the current pose estimate.

    Ball neighbourhood: ``cache`` = (slots, cnt_ok, r_eff2) of the last
    gather, reused when ``do_gather`` is False. Exact k-NN (reference
    :271-292): a fresh search each call, no cache; with
    num_closest_neighbors = kc > 1 the anchors are the kc nearest
    neighbours [K, kc, 3] and ``ok`` is [K, kc]. Returns (anchors, normals,
    geom_w, ok, cache)."""
    world = res.interp_world_points(qb, tb, qe, te, raw, alphas)
    filt = dict(sensor_location=sensor_location,
                use_normal_filter=statics.use_normal_filter)
    if statics.ball_neighborhood:
        k_nearest = dyn.max_number_neighbors if statics.knn_moments else None
        if do_gather:
            slots, cnt_ok = vm.gather_candidate_planes(
                level, world, valid, dyn.voxel_resolution,
                statics.voxel_neighborhood, dyn.threshold_voxel_occupancy,
                statics.max_candidate_voxels, **filt)
            cached_r = None
        else:
            slots, cnt_ok, cached_r = cache
        mom = vm.moments_from_planes(level, slots, cnt_ok, world, radius,
                                     k_nearest=k_nearest,
                                     cached_r_eff2=cached_r)
        count, anchors, normals, a2d = (mom.count, mom.closest, mom.normal,
                                        mom.a2d)
        closest_dist = torch.where(torch.isfinite(mom.closest_dist),
                                   mom.closest_dist,
                                   torch.zeros_like(mom.closest_dist))
        cache = (slots, cnt_ok, mom.r_eff2)
    else:
        nb = vm.radius_search(level, world, valid, radius,
                              dyn.voxel_resolution,
                              statics.voxel_neighborhood,
                              statics.max_neighbors,
                              threshold_voxel_occupancy=(
                                  dyn.threshold_voxel_occupancy), **filt)
        count = nb.mask.sum(-1)
        desc = compute_description(nb.points, nb.mask, world)
        anchors, normals, a2d = nb.points[:, 0], desc.normal, desc.a2D
        closest_dist = torch.where(nb.mask[:, 0], nb.dist[:, 0],
                                   torch.zeros_like(nb.dist[:, 0]))
    ok = valid & (count >= dyn.min_number_neighbors)
    geom_w = res.ceres_path_weights(
        a2d, closest_dist, dyn.power_planarity, dyn.weight_alpha,
        dyn.weight_neighborhood, dyn.max_dist_to_plane,
        np.float32(max(dyn.min_number_neighbors, 1)))
    kc = statics.num_closest_neighbors
    if not statics.ball_neighborhood and kc > 1:
        # kc residuals a keypoint, anchored at its kc nearest neighbours,
        # sharing its normal and weight (reference ct_icp.cpp:593-604)
        anchors = nb.points[:, :kc]
        ok = ok[:, None] & nb.mask[:, :kc]

    # cap the residuals by a uniform stride over the valid rows (the
    # reference caps a shuffled order; keypoints arrive voxel-sorted)
    ok_i = ok.reshape(-1).to(torch.int64)
    n_ok = torch.clamp_min(ok_i.sum(), 1)
    cap = dyn.max_num_residuals if dyn.max_num_residuals > 0 else 1 << 30
    rank = torch.cumsum(ok_i, 0) - 1
    cap_c = torch.clamp_max(n_ok, cap)
    sel = (torch.div(rank * cap_c, n_ok, rounding_mode="floor")
           != torch.div((rank - 1) * cap_c, n_ok, rounding_mode="floor"))
    ok = ok & (sel | (n_ok <= cap)).reshape(ok.shape)
    return anchors, normals, geom_w, ok, cache


def _lm_inner_loop(statics, dyn, raw, alphas, anchors, normals, geom_w, ok,
                   qb, tb, qe, te, prior):
    """ceres::Solve replacement: up to min(ls_max_num_iters, 64) damped-GN
    steps with IRLS weights and accept/reject damping, ending at the
    function-tolerance exit: one ``lm_loop`` call (kernel K5 on the card,
    kernels/lm_step.py), nothing read back. Returns (qb, tb, qe, te, cost,
    n_res, host_syncs)."""
    n_steps = min(dyn.ls_max_num_iters, MAX_INNER_ITERS)
    if n_steps < 1:
        raise ValueError("the LM inner loop needs ls_max_num_iters >= 1")
    if anchors.dim() == 3:
        # one row a (keypoint, i-th neighbour): the keypoint's arrays
        # repeated kc times, row i of keypoint j at j * kc + i
        kc = anchors.shape[1]
        raw, alphas = (raw.repeat_interleave(kc, 0),
                       alphas.repeat_interleave(kc, 0))
        normals = normals.repeat_interleave(kc, 0)
        geom_w = geom_w.repeat_interleave(kc, 0)
        anchors, ok = anchors.reshape(-1, 3), ok.reshape(-1)
    n_res = ok.sum(dtype=torch.int32)
    rows = lm.pack_rows(raw, alphas, anchors, normals, geom_w, ok)
    state = lm.init_state(qb, tb, qe, te)
    freeze_begin = statics.parametrization == PoseParametrization.SIMPLE
    lm.lm_loop(rows, prior, n_res, state, n_steps, statics.loss,
               dyn.ls_sigma, dyn.ls_tolerant_min_threshold, freeze_begin)
    return (state[0:4], state[4:7], state[7:11], state[11:14],
            state[lm.S_COST0], n_res, 0)


def build_register_fn(statics: SolverStatics):
    """The registration loop for ``statics``:
      (level, raw [K,3], alphas [K], valid [K], qb, tb, qe, te, prior [14],
       dyn) -> RegistrationResult
    with ``dyn`` a SolverDynamics or its packed vector."""
    if (statics.solver != Solver.CERES
            or statics.distance != IcpDistance.POINT_TO_PLANE
            or statics.analytic_jacobian):
        raise NotImplementedError(
            "ct_icp_torch ports the CERES point-to-plane path with the "
            f"autodiff Jacobian only; got {statics}")
    if statics.num_closest_neighbors > 1:
        # never a silent degrade to one residual a keypoint
        if statics.ball_neighborhood:
            raise ValueError(
                "num_closest_neighbors > 1 needs the sorted neighbor list: "
                "set ball_neighborhood=False (CTICPRegistration flips this "
                "automatically when building statics from options)")
        if statics.max_neighbors < statics.num_closest_neighbors:
            raise ValueError(
                f"num_closest_neighbors={statics.num_closest_neighbors} "
                f"exceeds max_number_neighbors={statics.max_neighbors}")

    def register(level, raw, alphas, valid, qb, tb, qe, te, prior, dyn):
        if not isinstance(dyn, SolverDynamics):
            dyn = unpack_dynamics(dyn)
        qb = s3.quat_normalize(qb)
        qe = s3.quat_normalize(qe)
        # the reference passes &end_t of the initial estimate (ct_icp.cpp:592)
        sensor_location = te
        radius = search_radius(statics, dyn, raw)
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
                radius, sensor_location, cache, do_gather)
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
