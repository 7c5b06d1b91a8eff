"""Host-side stamped poses and the per-scan continuous-time frame state.

Mirrors the capability surface of the reference's ``slam::Pose`` / stamped
``TPose`` (reference include/SlamCore/types.h:160-300) and
``ct_icp::TrajectoryFrame`` (reference include/ct_icp/types.h:31-62), as plain
float64 numpy dataclasses. The device-side solver consumes/produces raw
(quat, tr) arrays; these classes are the host bookkeeping around them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ct_icp_torch.core import se3_np as s3


@dataclasses.dataclass
class Pose:
    """A stamped SE3: quaternion (w, x, y, z) + translation + timestamp."""

    quat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))
    tr: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    timestamp: float = -1.0
    frame_id: int = -1

    def __post_init__(self):
        self.quat = np.asarray(self.quat, dtype=np.float64)
        self.tr = np.asarray(self.tr, dtype=np.float64)

    # ------------------------------------------------------------- algebra —
    def normalize_(self) -> "Pose":
        self.quat = s3.quat_normalize(self.quat)
        return self

    def matrix(self) -> np.ndarray:
        return s3.se3_matrix(self.quat, self.tr)

    @staticmethod
    def from_matrix(m: np.ndarray, timestamp: float = -1.0, frame_id: int = -1) -> "Pose":
        m = np.asarray(m, dtype=np.float64)
        return Pose(s3.quat_from_matrix(m[:3, :3]), m[:3, 3].copy(), timestamp, frame_id)

    def inverse(self) -> "Pose":
        q, t = s3.se3_inverse(self.quat, self.tr)
        return Pose(q, t, self.timestamp, self.frame_id)

    def __mul__(self, other):
        if isinstance(other, Pose):
            q, t = s3.se3_compose(self.quat, self.tr, other.quat, other.tr)
            return Pose(q, t, other.timestamp, other.frame_id)
        return self.apply(other)

    def apply(self, points: np.ndarray) -> np.ndarray:
        return s3.se3_apply(self.quat, self.tr, np.asarray(points, dtype=np.float64))

    # ------------------------------------------------------- interpolation —
    def alpha_timestamp(self, ts, other: "Pose"):
        """Reference GetAlphaTimestamp clamping (types.h:192-219)."""
        return s3.alpha_timestamp(
            np.asarray(ts, dtype=np.float64), self.timestamp, other.timestamp)

    def interpolate_alpha(self, other: "Pose", alpha) -> "Pose":
        q, t = s3.se3_interpolate(
            self.quat, self.tr, other.quat, other.tr, np.float64(alpha))
        ts = (1.0 - alpha) * self.timestamp + alpha * other.timestamp
        return Pose(q, t, ts, self.frame_id)

    # ------------------------------------------------------------ distances —
    def angular_distance(self, other: "Pose") -> float:
        return float(s3.angular_distance_deg(self.quat, other.quat))

    def location_distance(self, other: "Pose") -> float:
        return float(np.linalg.norm(self.tr - other.tr))

    def copy(self) -> "Pose":
        return Pose(self.quat.copy(), self.tr.copy(), self.timestamp, self.frame_id)

    @staticmethod
    def identity(timestamp: float = -1.0, frame_id: int = -1) -> "Pose":
        return Pose(timestamp=timestamp, frame_id=frame_id)


@dataclasses.dataclass
class TrajectoryFrame:
    """The 12-DoF continuous-time state of one scan: (begin_pose, end_pose).

    Reference: ct_icp/types.h:31-62.
    """

    begin_pose: Pose = dataclasses.field(default_factory=Pose)
    end_pose: Pose = dataclasses.field(default_factory=Pose)

    def ego_angular_distance(self) -> float:
        return self.begin_pose.angular_distance(self.end_pose)

    def copy(self) -> "TrajectoryFrame":
        return TrajectoryFrame(self.begin_pose.copy(), self.end_pose.copy())
