"""Generic segment-ATE trajectory metrics.

Host copy of ``ct_icp_tpu/evaluation/trajectory_metrics.py`` (numpy only, nothing of the JAX
package imported).

Counterpart of the reference's ``slam::ComputeTrajectoryMetrics``
(reference include/SlamCore/eval.h:79-103, src/SlamCore/eval.cxx:184-292):
whole-trajectory ATE after optimal rigid alignment, plus per-segment
max-location-error statistics over fixed-length trajectory segments
(the indoor/handheld analog of the KITTI driving RPE).
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.geometry import orthogonal_procrustes
from ct_icp_torch.core.pose import Pose


@dataclasses.dataclass
class TrajectorySegment:
    """One trajectory segment (reference segment_t, eval.h:79-84)."""

    segment_length: float = 0.0
    start_idx: int = -1
    end_idx: int = -1
    rigid_transform: Optional[Tuple[np.ndarray, np.ndarray]] = None


@dataclasses.dataclass
class TrajectoryMetrics:
    """Reference metrics_t (eval.h:86-99)."""

    trajectory_segments: List[TrajectorySegment] = dataclasses.field(
        default_factory=list)
    loc_errors: List[float] = dataclasses.field(default_factory=list)
    distances: List[float] = dataclasses.field(default_factory=list)
    segment_mean_ate_ratio: float = 0.0
    segment_mean_ate: float = 0.0
    total_distance: float = 0.0
    mean_ate: float = float("nan")
    max_ate: float = float("nan")
    max_ate_idx: int = -1
    rigid_transform: Optional[Tuple[np.ndarray, np.ndarray]] = None


def _locations(poses: Sequence) -> np.ndarray:
    out = np.zeros((len(poses), 3), np.float64)
    for i, p in enumerate(poses):
        out[i] = p.tr if isinstance(p, Pose) else np.asarray(p)[:3, 3]
    return out


def compute_trajectory_metrics(gt_trajectory: Sequence[Pose],
                               trajectory: Sequence[Pose],
                               segment_length: float = 10.0
                               ) -> TrajectoryMetrics:
    """Replicates ComputeTrajectoryMetrics (eval.cxx:184-292).

    Distances accumulate the GT relative translations; the whole-trajectory
    ATE aligns GT onto the estimate with an orthogonal Procrustes; segments
    close when their accumulated GT distance exceeds ``segment_length`` and
    contribute the max location error after per-segment alignment (segments
    with <= 5 poses are skipped, as in the reference).
    """
    assert segment_length > 0.0
    if len(gt_trajectory) <= 5:
        raise ValueError(
            "Cannot estimate the trajectory metrics with less than 5 poses")
    m = TrajectoryMetrics()

    ref = _locations(gt_trajectory)
    tgt = _locations(trajectory)

    # segment distances from GT relative poses (eval.cxx:191-201)
    dist = 0.0
    m.distances.append(0.0)
    for idx in range(len(gt_trajectory) - 1):
        g0, g1 = gt_trajectory[idx], gt_trajectory[idx + 1]
        rel_q, rel_t = s3n.se3_compose(
            *s3n.se3_inverse(g0.quat, g0.tr), g1.quat, g1.tr)
        dist += float(np.linalg.norm(rel_t))
        m.distances.append(dist)
    m.total_distance = m.distances[-1]

    # whole-trajectory ATE after optimal rigid alignment (eval.cxx:205-233)
    quat, tr = orthogonal_procrustes(ref, tgt)
    m.rigid_transform = (quat, tr)
    aligned = s3n.quat_rotate(quat, ref) + tr
    ate = np.linalg.norm(aligned - tgt, axis=1)
    m.mean_ate = float(ate.mean())
    m.max_ate_idx = int(ate.argmax())
    m.max_ate = float(ate[m.max_ate_idx])

    # per-segment max location error (eval.cxx:236-289)
    seg = TrajectorySegment(0.0, 0, 0)
    last_distance = 0.0
    for idx in range(len(m.distances)):
        seg.segment_length = m.distances[idx] - last_distance
        if seg.segment_length > segment_length:
            seg.end_idx = idx
            n = 1 + seg.end_idx - seg.start_idx
            if n > 5:
                sq, st = orthogonal_procrustes(
                    ref[seg.start_idx:idx + 1], tgt[seg.start_idx:idx + 1])
                seg.rigid_transform = (sq, st)
                seg_aligned = s3n.quat_rotate(sq, ref[seg.start_idx:idx + 1]) + st
                max_err = float(np.linalg.norm(
                    seg_aligned - tgt[seg.start_idx:idx + 1], axis=1).max())
                m.segment_mean_ate_ratio += max_err / seg.segment_length
                m.segment_mean_ate += max_err
                m.loc_errors.append(max_err)
                m.trajectory_segments.append(dataclasses.replace(seg))
            seg = TrajectorySegment(0.0, idx, 0)
            last_distance = m.distances[idx]
    if m.trajectory_segments:
        m.segment_mean_ate_ratio /= len(m.trajectory_segments)
        m.segment_mean_ate /= len(m.trajectory_segments)
    return m


def generate_trajectory_metrics_yaml(metrics: TrajectoryMetrics) -> str:
    """Reference GenerateTrajectoryMetricsYAMLNode (eval.cxx:295-306)."""
    lines = [
        f"MAX_ATE: {metrics.max_ate}",
        f"MEAN_ATE: {metrics.mean_ate}",
        f"MAX_ATE_IDX: {metrics.max_ate_idx}",
        f"SEGMENT_MEAN_ATE_RATIO: {metrics.segment_mean_ate_ratio}",
        f"SEGMENT_MEAN_ATE: {metrics.segment_mean_ate}",
        f"NUM_SEGMENTS: {len(metrics.trajectory_segments)}",
        f"TOTAL_DISTANCE: {metrics.total_distance}",
    ]
    return "\n".join(lines) + "\n"
