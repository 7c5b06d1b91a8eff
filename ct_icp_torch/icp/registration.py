"""Host-facing registration configuration — counterpart of the statics and
dynamics part of ``ct_icp_tpu/icp/registration.py::CTICPRegistration`` and
its ``make_prior``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ct_icp_torch.config.options import (CTICPOptions, LeastSquares,
                                         MultiResolutionVoxelMapOptions,
                                         Solver)
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.pose import TrajectoryFrame
from ct_icp_torch.icp import solver as slv


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
