"""Motion model: trajectory prior + prediction (host side).

Counterpart of ``ct_icp_tpu/odometry/motion_model.py::
PreviousFrameMotionModel`` (reference motion_model.cpp:12-115); the
constraint rows themselves are icp/residuals.py::motion_prior_residuals.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ct_icp_torch.config.options import MotionModelOptions, MotionModelType
from ct_icp_torch.core.pose import TrajectoryFrame
from ct_icp_torch.icp.registration import make_prior


class PreviousFrameMotionModel:
    """Reference PreviousFrameMotionModel (motion_model.cpp:12-115)."""

    def __init__(self, options: Optional[MotionModelOptions] = None):
        self.options = options or MotionModelOptions()
        self.previous_frame = TrajectoryFrame()

    def reset(self):
        self.previous_frame = TrajectoryFrame()

    def update_state(self, optimized_frame: TrajectoryFrame, frame_index: int):
        self.previous_frame = optimized_frame.copy()

    def next_frame(self) -> TrajectoryFrame:
        """Predict the next frame (motion_model.cpp:85-103)."""
        prev = self.previous_frame
        nxt = prev.copy()
        dt = prev.end_pose.timestamp - prev.begin_pose.timestamp
        nxt.end_pose.timestamp = prev.end_pose.timestamp + dt
        if self.options.model == MotionModelType.CONSTANT_VELOCITY:
            nxt.begin_pose = prev.end_pose.copy()
            rel = prev.begin_pose.inverse() * prev.end_pose
            moved = rel * prev.end_pose
            nxt.end_pose.quat = moved.quat
            nxt.end_pose.tr = moved.tr
            return nxt
        nxt.begin_pose.quat = prev.end_pose.quat.copy()
        nxt.begin_pose.tr = prev.end_pose.tr.copy()
        nxt.end_pose.quat = prev.end_pose.quat.copy()
        nxt.end_pose.tr = prev.end_pose.tr.copy()
        return nxt

    def is_valid(self, frame: TrajectoryFrame) -> bool:
        """Compare prediction with the optimized frame (motion_model.cpp:64-82)."""
        pred = self.next_frame()
        o = self.options
        return (pred.begin_pose.angular_distance(frame.begin_pose) < o.threshold_orientation_deg
                and pred.end_pose.angular_distance(frame.end_pose) < o.threshold_orientation_deg
                and pred.begin_pose.location_distance(frame.begin_pose) < o.threshold_translation_diff
                and pred.end_pose.location_distance(frame.end_pose) < o.threshold_translation_diff)

    def device_prior(self, origin: np.ndarray) -> np.ndarray:
        """Packed prior vector for the solver (see registration.make_prior)."""
        return make_prior(self.previous_frame, self.options, origin)
