"""Host-facing registration API — counterpart of
``ct_icp_tpu/icp/registration.py``: ``CTICPRegistration`` (the solver
statics and packed dynamics for a map configuration, ``register_device`` on
keypoints already on the device, ``register_profiled`` (the same loop with
the ICPSummary phase durations), ``register``, numpy in and out, the
counterpart of the reference's ``CT_ICP_Registration::Register``,
ct_icp.h:174-223, and ``debug_problem``, the reference's OutputBuilder
arrays), its ``ICPSummary`` and ``make_prior``.

Timestamps become alpha-parameters in [0, 1] on the host in float64
(reference GetAlphaTimestamp, types.h:192-219), so device code never holds
raw timestamps in float32.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ct_icp_torch import resolve_device
from ct_icp_torch.config.options import (CTICPOptions, LeastSquares,
                                         MultiResolutionVoxelMapOptions,
                                         PoseParametrization, Solver)
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.pose import TrajectoryFrame
from ct_icp_torch.icp import residuals as res
from ct_icp_torch.icp import solver as slv
from ct_icp_torch.kernels import scan_transform as k14


@dataclasses.dataclass
class ICPSummary:
    """Mirror of the reference ICPSummary (ct_icp.h:155-169); durations in
    ms. ``host_syncs``: the device->host reads the registration made."""

    success: bool = False
    num_residuals_used: int = 0
    num_iters: int = 0
    error_log: str = ""
    duration_total: float = 0.0
    duration_init: float = 0.0
    avg_duration_iter: float = 0.0
    avg_duration_neighborhood: float = 0.0
    avg_duration_solve: float = 0.0
    host_syncs: int = 0


def fill_durations(summary: ICPSummary, timer, num_iters: int) -> None:
    """The ICPSummary phase durations (ms) from a ``solver.PhaseTimer``."""
    k = max(int(num_iters), 1)
    nb, solve = timer.ms["neighborhood"], timer.ms["solve"]
    summary.duration_init = timer.ms["init"]
    summary.avg_duration_neighborhood = nb / k
    summary.avg_duration_solve = solve / k
    summary.avg_duration_iter = (nb + solve) / k


def make_prior(previous_frame: Optional[TrajectoryFrame], motion_options,
               origin: np.ndarray) -> np.ndarray:
    """Packed [14] prior vector from the previous trajectory frame
    (reference PreviousFrameMotionModel, motion_model.cpp:12-61):
    [prev_end_quat(4), prev_end_tr(3), prev_velocity(3),
     beta_loc, beta_orient, beta_cv, beta_sv]."""
    out = np.zeros(14, dtype=np.float32)
    out[0] = 1.0
    if previous_frame is None or motion_options is None:
        return out
    out[0:4] = s3n.quat_normalize(previous_frame.end_pose.quat)
    out[4:7] = previous_frame.end_pose.tr - origin
    out[7:10] = previous_frame.end_pose.tr - previous_frame.begin_pose.tr
    out[10] = motion_options.beta_location_consistency
    out[11] = motion_options.beta_orientation_consistency
    out[12] = motion_options.beta_constant_velocity
    out[13] = motion_options.beta_small_velocity
    return out


class CTICPRegistration:
    """Solver statics + packed dynamics for a map configuration and the
    registration function they select."""

    def __init__(self, options: CTICPOptions,
                 map_options: MultiResolutionVoxelMapOptions,
                 num_keypoints: int,
                 search_radius: Optional[float] = None,
                 distance_strategy=None):
        self.options = options
        self.map_options = map_options
        self.distance_strategy = distance_strategy
        if distance_strategy is not None:
            # per-point radii up to radius_max: the level and nv that
            # SearchParamsFromRadiusSearch picks for radius_max
            radius = distance_strategy.radius_max
        else:
            radius = (search_radius if search_radius is not None
                      else map_options.default_radius)
        level_idx, nv = map_options.search_params(radius)
        self.level_index = level_idx
        self.search_radius = radius
        self.voxel_resolution = map_options.resolutions[level_idx].resolution
        loss = options.loss_function
        if options.solver == Solver.GN:
            loss = LeastSquares.STANDARD  # reference GN path has no robust loss
        self.statics = slv.SolverStatics(
            num_keypoints=num_keypoints,
            max_neighbors=options.max_number_neighbors,
            level_index=level_idx,
            voxel_neighborhood=nv,
            distance=options.distance,
            loss=loss,
            solver=options.solver,
            parametrization=options.parametrization,
            num_closest_neighbors=options.num_closest_neighbors,
            # the strategy passes the sensor location: the normal filter
            use_normal_filter=(
                distance_strategy is not None
                and map_options.select_valid_normals_direction),
            use_barycenter=options.use_barycenter,
            use_lines=options.use_lines,
            use_distribution=options.use_distribution,
            use_distance_strategy=distance_strategy is not None,
            # kc > 1 anchors at the i-th nearest: the sorted list
            ball_neighborhood=(options.ball_neighborhood
                               and options.num_closest_neighbors <= 1),
            knn_moments=options.knn_moments,
            analytic_jacobian=options.analytic_jacobian,
            max_candidate_voxels=(
                0 if (2 * nv + 1) ** 3 <= 27 else
                min(48, (2 * nv + 1) ** 3)),
        )
        self.register_fn = slv.build_register_fn(self.statics)
        self._dyn_cache = {}

    def dynamics(self, options: Optional[CTICPOptions] = None) -> np.ndarray:
        """Packed dynamic-scalar vector, cached per options object."""
        opts = options or self.options
        out = self._dyn_cache.get(opts)
        if out is None:
            out = slv.pack_dynamics(opts, self.search_radius,
                                    self.voxel_resolution,
                                    self.distance_strategy)
            self._dyn_cache[opts] = out
        return out

    def register_device(self, map_state, raw, alphas, valid,
                        frame: TrajectoryFrame, prior=None,
                        origin: Optional[np.ndarray] = None,
                        options: Optional[CTICPOptions] = None) -> ICPSummary:
        """Registration of keypoints on the device (updates ``frame`` in
        place; reference registration.py:221-268): ``raw`` f32[K, 3],
        ``alphas`` f32[K] (already in [0, 1]) and ``valid`` bool[K] on the
        map's device. ``origin`` is the world location of the map frame
        (float64): the poses are shifted into it for the float32 solve and
        back, then normalised. ``prior`` is a packed [14] motion prior
        (:func:`make_prior`) or the [41] one of
        ``PredictionConsistencyModel.device_prior`` (None: no prior). One
        readback of the result besides the solver's (one an ICP
        iteration)."""
        return self._register(map_state, raw, alphas, valid, frame, prior,
                              origin, options, profiled=False)

    def register_profiled(self, map_state, raw, alphas, valid,
                          frame: TrajectoryFrame, prior=None,
                          origin: Optional[np.ndarray] = None,
                          options: Optional[CTICPOptions] = None
                          ) -> ICPSummary:
        """:meth:`register_device` with the reference ICPSummary durations
        (ct_icp.h:155-169, filled at ct_icp.cpp:664-694; reference
        registration.py:338-405): the same solver loop, synchronizing the
        device at its phase boundaries (``solver.PhaseTimer``), so
        ``duration_init``, ``avg_duration_iter``,
        ``avg_duration_neighborhood`` and ``avg_duration_solve`` (ms) are
        the phases' wall times. Each boundary waits for the device: for
        observability, not throughput."""
        return self._register(map_state, raw, alphas, valid, frame, prior,
                              origin, options, profiled=True)

    def _register(self, map_state, raw, alphas, valid, frame, prior, origin,
                  options, profiled: bool) -> ICPSummary:
        t0 = time.time()
        origin = np.zeros(3) if origin is None else np.asarray(origin)
        opts = options or self.options
        dev = raw.device
        if prior is None:
            prior = make_prior(None, None, origin)
        prior = np.asarray(prior, np.float32)
        if prior.shape not in ((14,), (41,)):
            raise ValueError(f"a packed prior is [14] or [41], got "
                             f"{prior.shape}")
        init = np.concatenate([
            s3n.quat_normalize(frame.begin_pose.quat),
            frame.begin_pose.tr - origin,
            s3n.quat_normalize(frame.end_pose.quat),
            frame.end_pose.tr - origin]).astype(np.float32)
        host = torch.as_tensor(np.concatenate([init, prior]), device=dev)
        timer = slv.PhaseTimer(dev) if profiled else None
        result = self.register_fn(
            map_state[self.level_index], raw, alphas, valid, host[0:4],
            host[4:7], host[7:11], host[11:14], host[14:], self.dynamics(opts),
            timer=timer)
        r = torch.cat([result.quat_begin, result.tr_begin, result.quat_end,
                       result.tr_end,
                       result.num_residuals.to(torch.float32).reshape(1)]
                      ).cpu().numpy().astype(np.float64)
        frame.begin_pose.quat = r[0:4]
        frame.begin_pose.tr = r[4:7] + origin
        frame.end_pose.quat = r[7:11]
        frame.end_pose.tr = r[11:14] + origin
        frame.begin_pose.normalize_()
        frame.end_pose.normalize_()

        summary = ICPSummary()
        summary.num_residuals_used = int(r[14])
        summary.num_iters = int(result.num_iters)
        summary.success = bool(result.valid_problem)
        summary.host_syncs = result.host_syncs + 1
        if not summary.success:
            summary.error_log = (
                "[CT_ICP] Error : not enough keypoints selected in ct-icp ! "
                f"number_of_residuals : {summary.num_residuals_used}")
        if timer is not None:
            fill_durations(summary, timer, result.num_iters)
        summary.duration_total = (time.time() - t0) * 1000.0
        return summary

    def debug_problem(self, map_state, raw_kpts: np.ndarray,
                      timestamps: np.ndarray, frame: TrajectoryFrame,
                      origin: Optional[np.ndarray] = None,
                      options: Optional[CTICPOptions] = None,
                      device=None) -> dict:
        """Per-point problem arrays at the frame's current pose: what the
        reference's OutputBuilder exposes behind output_weights /
        output_normals / output_residuals (ct_icp.cpp:1075-1177; reference
        registration.py:270-336). Numpy arrays for the valid prefix, keyed
        world, anchors, normals, lines, weights, ok, classification (the
        ROBUST class, None elsewhere) and residuals (the statics'
        distance). Off the hot path; ``register`` is unaffected."""
        opts = options or self.options
        origin = np.zeros(3) if origin is None else np.asarray(origin)
        statics = self.statics
        k = statics.num_keypoints
        n = raw_kpts.shape[0]
        raw = np.zeros((k, 3), np.float32)
        raw[:n] = raw_kpts
        valid = np.zeros((k,), bool)
        valid[:n] = True
        alphas = np.ones((k,), np.float32)
        alphas[:n] = s3n.alpha_timestamp(
            np.asarray(timestamps, np.float64),
            frame.begin_pose.timestamp, frame.end_pose.timestamp)
        init = np.concatenate([
            s3n.quat_normalize(frame.begin_pose.quat),
            frame.begin_pose.tr - origin,
            s3n.quat_normalize(frame.end_pose.quat),
            frame.end_pose.tr - origin]).astype(np.float32)
        dev = resolve_device(device)
        raw_t, alphas_t, valid_t, pose = (torch.from_numpy(a).to(dev) for a
                                          in (raw, alphas, valid, init))
        qb, tb, qe, te = pose[0:4], pose[4:7], pose[7:11], pose[11:14]
        dyn = slv.unpack_dynamics(self.dynamics(opts))
        p = slv._build_problem(
            statics, dyn, map_state[self.level_index], raw_t, alphas_t,
            valid_t, qb, tb, qe, te, slv.search_radius(statics, dyn, raw_t),
            te, None, True, full=True)
        world = k14.transform(raw_t, alphas_t, qb, tb, qe, te)
        r = res.geometric_residuals(statics.distance, world, p.anchors,
                                    p.normals, p.lines, p.cov_inv, p.geom_w)
        out = [x if x is None else x.cpu().numpy()
               for x in (world, p.anchors, p.normals, p.lines, p.geom_w,
                         p.ok, p.cls, r)]
        # a missing array (the class outside ROBUST) broadcast to [K]
        world, anchors, normals, lines, geom_w, ok, cls, r = (
            np.broadcast_to(np.asarray(x), (k,) + np.shape(x)[1:])
            if np.ndim(x) == 0 else np.asarray(x) for x in out)
        return {
            "world": world[:n] + origin,
            "anchors": anchors[:n] + origin,
            "normals": normals[:n],
            "lines": lines[:n],
            "weights": geom_w[:n],
            "ok": ok[:n],
            "classification": cls[:n],
            "residuals": r[:n],
        }

    def register(self, map_state, raw_kpts: np.ndarray,
                 timestamps: np.ndarray, frame: TrajectoryFrame, prior=None,
                 origin: Optional[np.ndarray] = None,
                 options: Optional[CTICPOptions] = None,
                 device=None) -> ICPSummary:
        """Numpy-in / numpy-out registration (updates ``frame`` in place;
        reference registration.py:407-438): the keypoints padded to the
        static ``num_keypoints``, the alpha-timestamps computed on the host
        in float64 (all ones with the SIMPLE parametrization), then
        :meth:`register_device` on ``device`` (the card unless the caller
        names another; the map must be there)."""
        opts = options or self.options
        k = self.statics.num_keypoints
        n = raw_kpts.shape[0]
        if n > k:
            raise ValueError(f"{n} keypoints > static capacity {k}")
        raw = np.zeros((k, 3), np.float32)
        raw[:n] = raw_kpts
        valid = np.zeros((k,), bool)
        valid[:n] = True
        alphas64 = s3n.alpha_timestamp(
            np.asarray(timestamps, np.float64),
            frame.begin_pose.timestamp, frame.end_pose.timestamp)
        if opts.parametrization == PoseParametrization.SIMPLE:
            alphas64 = np.ones_like(alphas64)
        alphas = np.ones((k,), np.float32)
        alphas[:n] = alphas64
        dev = resolve_device(device)
        return self.register_device(
            map_state, torch.from_numpy(raw).to(dev),
            torch.from_numpy(alphas).to(dev),
            torch.from_numpy(valid).to(dev), frame, prior=prior,
            origin=origin, options=opts)
