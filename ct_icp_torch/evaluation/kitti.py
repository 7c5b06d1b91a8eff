"""KITTI odometry metrics: segment RPE, APE, local errors.

Host copy of ``ct_icp_tpu/evaluation/kitti.py`` (:28-163), the reference's
KITTI-devkit evaluation (reference include/SlamCore/eval.h:1-110,
src/SlamCore/eval.cxx:35-180):
  * ``compute_mean_rpe`` over segment lengths {100..800} m (driving) or
    {10..80} m (indoor), start step 10 frames, in percent (%Tr);
  * mean / max APE (absolute translation error);
  * mean / max local (frame-to-frame distance) error;
  * the estimate as a continuous trajectory, interpolated at each GT
    timestamp (eval.cxx:103-110), and the ``metrics.yaml`` text
    (eval.cxx:113-133).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from ct_icp_torch.core.pose import Pose
from ct_icp_torch.core.trajectory import LinearContinuousTrajectory

KITTI_SEGMENT_LENGTHS = [100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0]
INDOOR_SEGMENT_LENGTHS = [10.0, 20.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0]


@dataclasses.dataclass
class SeqErrors:
    """Reference slam::kitti::seq_errors (eval.h:29-60)."""

    mean_rpe: float = 0.0
    mean_ape: float = 0.0
    max_ape: float = 0.0
    mean_local_err: float = 0.0
    max_local_err: float = 0.0
    index_max_local_err: int = 0
    average_elapsed_ms: float = -1.0
    mean_num_attempts: float = -1.0
    success: bool = True
    finished: bool = True
    tab_errors: List = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, float]:
        return {
            "MAX_APE": self.max_ape,
            "MEAN_APE": self.mean_ape,
            "MEAN_RPE": self.mean_rpe,
            "MEAN_LOCAL_ERROR": self.mean_local_err,
            "MAX_LOCAL_ERROR": self.max_local_err,
            "INDEX_MAX_LOCAL_ERROR": self.index_max_local_err,
            "Average(ms)": self.average_elapsed_ms,
            "AVG_NUM_ATTEMPTS": self.mean_num_attempts,
            "success": self.success,
            "finished": self.finished,
        }


def _translation_error(pose_err: np.ndarray) -> float:
    return float(np.linalg.norm(pose_err[:3, 3]))


def _rotation_error(pose_err: np.ndarray) -> float:
    d = 0.5 * (pose_err[0, 0] + pose_err[1, 1] + pose_err[2, 2] - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def _trajectory_distances(poses: Sequence[np.ndarray]) -> np.ndarray:
    """Cumulative path length; the reference accumulates the norm of the
    matrix DIFFERENCE translation block (eval.cxx:19-24) — identical to the
    distance between consecutive translations."""
    dist = [0.0]
    for i in range(1, len(poses)):
        dist.append(dist[-1] + float(
            np.linalg.norm(poses[i][:3, 3] - poses[i - 1][:3, 3])))
    return np.asarray(dist)


def _last_frame_from_segment_length(dist, first, length) -> int:
    idx = np.searchsorted(dist, dist[first] + length, side="right")
    return int(idx) if idx < len(dist) else -1


def compute_mean_rpe(poses_gt: Sequence[np.ndarray],
                     poses_est: Sequence[np.ndarray],
                     seq_err: SeqErrors,
                     step_size: int = 10,
                     lengths: Sequence[float] = KITTI_SEGMENT_LENGTHS) -> float:
    """Reference ComputeMeanRPE (eval.cxx:35-76); returns percent."""
    dist = _trajectory_distances(poses_gt)
    num_total = 0
    mean_rpe = 0.0
    for first in range(0, len(poses_gt), step_size):
        for length in lengths:
            last = _last_frame_from_segment_length(dist, first, length)
            if last == -1:
                continue
            delta_gt = np.linalg.inv(poses_gt[first]) @ poses_gt[last]
            delta_est = np.linalg.inv(poses_est[first]) @ poses_est[last]
            err = np.linalg.inv(delta_est) @ delta_gt
            t_err = _translation_error(err)
            r_err = _rotation_error(err)
            seq_err.tab_errors.append((t_err / length, r_err / length))
            mean_rpe += t_err / length
            num_total += 1
    if num_total == 0:
        return 0.0
    return mean_rpe / num_total * 100.0


def evaluate_matrices(poses_gt: Sequence[np.ndarray],
                      poses_est: Sequence[np.ndarray],
                      lengths: Sequence[float] = KITTI_SEGMENT_LENGTHS
                      ) -> SeqErrors:
    """Reference EvaluatePoses over 4x4 matrices (eval.cxx:136-180)."""
    assert len(poses_gt) > 0 and len(poses_gt) == len(poses_est), \
        "Couldn't evaluate (all) poses"
    err = SeqErrors()
    apes = [
        _translation_error(np.linalg.inv(e) @ g)
        for g, e in zip(poses_gt, poses_est)
    ]
    err.mean_ape = float(np.mean(apes))
    err.max_ape = float(np.max(apes))

    local = []
    for i in range(1, len(poses_gt)):
        d_gt = np.linalg.norm(poses_gt[i][:3, 3] - poses_gt[i - 1][:3, 3])
        d_est = np.linalg.norm(poses_est[i][:3, 3] - poses_est[i - 1][:3, 3])
        local.append(abs(d_gt - d_est))
    if local:
        err.mean_local_err = float(np.mean(local))
        err.max_local_err = float(np.max(local))
        err.index_max_local_err = int(np.argmax(local)) + 1
    err.mean_rpe = compute_mean_rpe(poses_gt, poses_est, err, 10, lengths)
    return err


def evaluate_poses(poses_gt: Sequence[Pose], poses_est: Sequence[Pose],
                   driving: bool = True) -> SeqErrors:
    lengths = KITTI_SEGMENT_LENGTHS if driving else INDOOR_SEGMENT_LENGTHS
    return evaluate_matrices([p.matrix() for p in poses_gt],
                             [p.matrix() for p in poses_est], lengths)


def evaluate_continuous_trajectory(poses_gt: Sequence[Pose],
                                   trajectory: LinearContinuousTrajectory,
                                   driving: bool = True) -> SeqErrors:
    """Interpolate the estimate at every GT timestamp
    (reference eval.cxx:103-110)."""
    est = [trajectory.interpolate_pose(p.timestamp, clip=True)
           for p in poses_gt]
    return evaluate_poses(poses_gt, est, driving)


def generate_metrics_yaml(metrics: Dict[str, SeqErrors]) -> str:
    """YAML text matching the reference metric dump
    (GenerateMetricYAMLNode, eval.cxx:113-133)."""
    lines = []
    for name, err in metrics.items():
        lines.append(f'"{name}":')  # quoted: "00" must stay a string key
        for k, v in err.to_dict().items():
            lines.append(f"  {k}: {v}")
    return "\n".join(lines) + "\n"
