"""Motion models: trajectory prior + prediction (host side).

Counterpart of ``ct_icp_tpu/odometry/motion_model.py``:
``PreviousFrameMotionModel`` (reference motion_model.cpp:12-115) and
``PredictionConsistencyModel`` (:117-283); the constraint rows themselves
are icp/residuals.py::motion_prior_residuals and
prediction_consistency_residuals.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

from ct_icp_torch.config.options import MotionModelOptions, MotionModelType
from ct_icp_torch.core import se3_np as s3n
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


# CONSTRAINT_TYPE bitmask (reference motion_model.h:85-91)
CONSTRAINT_NONE = 0
CONSTRAINT_ON_BEGIN = 1
CONSTRAINT_ON_END = 2
RELATIVE_TRANSFORM_CONSTRAINT = 4
CONSTRAINT_ALL = (CONSTRAINT_ON_BEGIN | CONSTRAINT_ON_END
                  | RELATIVE_TRANSFORM_CONSTRAINT)


@dataclasses.dataclass
class PredictionConsistencyOptions:
    """Reference PredictionConsistencyModel::Options
    (motion_model.h:93-110)."""

    model: int = CONSTRAINT_ALL
    alpha_begin_tr_constraint: float = 0.0
    alpha_end_tr_constraint: float = 0.0
    alpha_begin_rot_constraint: float = 0.0
    alpha_end_rot_constraint: float = 0.0
    alpha_relative_rot_constraint: float = 100.0
    alpha_relative_tr_constraint: float = 60.0
    beta_scale_rot_deg: float = 1.0
    beta_scale_tr_m: float = 0.1
    threshold_rot_deg: float = 5.0
    threshold_tr_m: float = 0.5
    log_if_invalid: bool = True


class PredictionConsistencyModel:
    """Constraints against a prediction supplied from outside (reference
    motion_model.cpp:117-283): the rows are
    residuals.prediction_consistency_residuals on the device; this class
    packs them (:meth:`device_prior`) and checks validity."""

    def __init__(self,
                 options: Optional[PredictionConsistencyOptions] = None):
        self.options = options or PredictionConsistencyOptions()
        self.prediction = TrajectoryFrame()

    def set_prediction(self, frame: TrajectoryFrame):
        self.prediction = frame.copy()

    def next_frame(self) -> TrajectoryFrame:
        return self.prediction.copy()

    def update_state(self, optimized_frame: TrajectoryFrame, frame_index: int):
        pass

    def reset(self):
        self.prediction = TrajectoryFrame()

    def is_valid(self, frame: TrajectoryFrame) -> bool:
        """Per-constraint-type thresholds (reference
        motion_model.cpp:128-185)."""
        o = self.options
        pred = self.prediction
        checks = []
        if o.model & CONSTRAINT_ON_BEGIN:
            checks += [
                pred.begin_pose.location_distance(frame.begin_pose)
                <= o.threshold_tr_m,
                pred.begin_pose.angular_distance(frame.begin_pose)
                <= o.threshold_rot_deg]
        if o.model & CONSTRAINT_ON_END:
            checks += [
                pred.end_pose.location_distance(frame.end_pose)
                <= o.threshold_tr_m,
                pred.end_pose.angular_distance(frame.end_pose)
                <= o.threshold_rot_deg]
        if o.model & RELATIVE_TRANSFORM_CONSTRAINT:
            rel_pred = pred.begin_pose.inverse() * pred.end_pose
            rel_opt = frame.begin_pose.inverse() * frame.end_pose
            checks += [
                float(np.linalg.norm(rel_opt.tr - rel_pred.tr))
                <= o.threshold_tr_m,
                rel_opt.angular_distance(rel_pred) <= o.threshold_rot_deg]
        ok = all(checks)
        if not ok and o.log_if_invalid:
            logging.getLogger(__name__).info(
                "Registration not consistent with the prediction motion model")
        return ok

    def device_prior(self, origin: np.ndarray) -> np.ndarray:
        """Packed [41] prior: a PreviousFrameMotionModel block with zero
        betas (0:14), then the predicted begin, end and relative poses and
        the six weights alpha / beta_scale (reference
        AddConstraintsToCeresProblem, motion_model.cpp:188-283): a
        constraint type counts only when its bit is set in ``model`` and
        its beta scale is positive; both relative rows need both scales."""
        o = self.options
        pred = self.prediction
        origin = np.asarray(origin, np.float64)
        out = np.zeros(41, dtype=np.float32)
        out[0] = 1.0  # identity prev_end_quat; betas stay 0 -> rows vanish
        out[14:18] = s3n.quat_normalize(pred.begin_pose.quat)
        out[18:21] = pred.begin_pose.tr - origin
        out[21:25] = s3n.quat_normalize(pred.end_pose.quat)
        out[25:28] = pred.end_pose.tr - origin
        rel = pred.begin_pose.inverse() * pred.end_pose
        out[28:32] = s3n.quat_normalize(rel.quat)
        out[32:35] = rel.tr  # the origin shift cancels in begin^-1 * end
        if o.model & CONSTRAINT_ON_BEGIN and o.beta_scale_tr_m > 0:
            out[35] = o.alpha_begin_tr_constraint / o.beta_scale_tr_m
        if o.model & CONSTRAINT_ON_BEGIN and o.beta_scale_rot_deg > 0:
            out[36] = o.alpha_begin_rot_constraint / o.beta_scale_rot_deg
        if o.model & CONSTRAINT_ON_END and o.beta_scale_tr_m > 0:
            out[37] = o.alpha_end_tr_constraint / o.beta_scale_tr_m
        if o.model & CONSTRAINT_ON_END and o.beta_scale_rot_deg > 0:
            out[38] = o.alpha_end_rot_constraint / o.beta_scale_rot_deg
        if (o.model & RELATIVE_TRANSFORM_CONSTRAINT
                and o.beta_scale_rot_deg > 0 and o.beta_scale_tr_m > 0):
            out[39] = o.alpha_relative_rot_constraint / o.beta_scale_rot_deg
            out[40] = o.alpha_relative_tr_constraint / o.beta_scale_tr_m
        return out
