"""Piecewise-linear continuous-time trajectory over sorted stamped poses.

Host-side (numpy, float64) counterpart of the reference's
``slam::LinearContinuousTrajectory`` (reference include/SlamCore/trajectory.h:28-130,
src/SlamCore/trajectory.cxx): timestamp interpolation, per-point transforms,
relative-pose conversion and reference-frame changes.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ct_icp_torch.core import se3_np as s3
from ct_icp_torch.core.pose import Pose


class LinearContinuousTrajectory:
    """Sorted stamped poses; interpolates with slerp+lerp between neighbors."""

    def __init__(self, poses: Sequence[Pose], check_sorted: bool = True):
        poses = [p.copy() for p in poses]
        if check_sorted:
            ts = [p.timestamp for p in poses]
            if any(b < a for a, b in zip(ts, ts[1:])):
                poses.sort(key=lambda p: p.timestamp)
        self._poses: List[Pose] = poses
        self._timestamps = np.array([p.timestamp for p in poses], dtype=np.float64)
        self._quats = np.stack([p.quat for p in poses]) if poses else np.zeros((0, 4))
        self._trs = np.stack([p.tr for p in poses]) if poses else np.zeros((0, 3))

    @staticmethod
    def create(poses: Sequence[Pose]) -> "LinearContinuousTrajectory":
        return LinearContinuousTrajectory(poses)

    @property
    def poses(self) -> List[Pose]:
        return self._poses

    @property
    def timestamps(self) -> np.ndarray:
        return self._timestamps

    def __len__(self) -> int:
        return len(self._poses)

    # ---------------------------------------------------------------- query —
    def _bracket(self, timestamps: np.ndarray):
        """Indices (i0, i1) of the pose pair bracketing each timestamp.

        Out-of-range timestamps clamp to the first/last segment, matching the
        reference's clamped-interpolation behavior when `clip` is requested.
        """
        idx = np.searchsorted(self._timestamps, timestamps, side="right")
        i1 = np.clip(idx, 1, len(self._poses) - 1) if len(self._poses) > 1 \
            else np.zeros_like(idx)
        i0 = np.maximum(i1 - 1, 0)
        return i0, i1

    def interpolate_pose(self, timestamp: float, clip: bool = True) -> Pose:
        q, t = self.interpolate_poses(np.asarray([timestamp], dtype=np.float64), clip)
        return Pose(q[0], t[0], timestamp)

    def interpolate_poses(self, timestamps: np.ndarray, clip: bool = True):
        """Vectorized interpolation -> (quats [N,4], trs [N,3])."""
        timestamps = np.asarray(timestamps, dtype=np.float64)
        if len(self._poses) == 0:
            raise ValueError("Empty trajectory")
        if len(self._poses) == 1:
            n = timestamps.shape[0]
            return (np.broadcast_to(self._quats[0], (n, 4)).copy(),
                    np.broadcast_to(self._trs[0], (n, 3)).copy())
        if not clip:
            if np.any(timestamps < self._timestamps[0] - 1e-9) or \
                    np.any(timestamps > self._timestamps[-1] + 1e-9):
                raise ValueError("Timestamps outside of the trajectory support")
        i0, i1 = self._bracket(timestamps)
        t0, t1 = self._timestamps[i0], self._timestamps[i1]
        denom = np.where(t1 - t0 <= 0, 1.0, t1 - t0)
        alpha = np.clip((timestamps - t0) / denom, 0.0, 1.0)
        q, t = s3.se3_interpolate(
            self._quats[i0], self._trs[i0], self._quats[i1], self._trs[i1], alpha)
        return q, t

    def transform_points(self, raw_points: np.ndarray, timestamps: np.ndarray):
        """Raw points + per-point timestamps -> world points [N, 3]."""
        q, t = self.interpolate_poses(timestamps)
        return s3.quat_rotate(q, np.asarray(raw_points, dtype=np.float64)) + t

    # ------------------------------------------------------------ transforms —
    def to_relative_poses(self) -> List[Pose]:
        """Pose deltas between consecutive poses; the first is absolute."""
        out = []
        prev = None
        for p in self._poses:
            out.append(p.copy() if prev is None else prev.inverse() * p)
            prev = p
        return out

    @staticmethod
    def from_relative_poses(rel: Sequence[Pose]) -> "LinearContinuousTrajectory":
        acc = None
        out = []
        for p in rel:
            acc = p.copy() if acc is None else acc * p
            acc.timestamp = p.timestamp
            out.append(acc.copy())
        return LinearContinuousTrajectory(out)

    def change_reference_frame(self, new_ref: Pose) -> "LinearContinuousTrajectory":
        """Left-multiply every pose by ``new_ref`` (reference-frame change)."""
        return LinearContinuousTrajectory([new_ref * p for p in self._poses])

    def select_window(self, t_min: float, t_max: float) -> "LinearContinuousTrajectory":
        keep = [p for p in self._poses if t_min <= p.timestamp <= t_max]
        return LinearContinuousTrajectory(keep)
