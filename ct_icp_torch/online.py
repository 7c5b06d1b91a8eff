"""Online odometry front-end — the ROS-node capability without ROS; the
port's counterpart of ``ct_icp_tpu/online.py``.

Replicates the behavior of the reference's ROS odometry node
(reference ros/catkin_ws/ct_icp_odometry/src/ct_icp_odometry_node.cxx):
  * a streaming callback API for incoming point clouds,
  * timestamp-consistency gating against the expected frame period
    (node r_dt in [0.95, 1.05] of the expected period, cxx:134-165),
  * per-frame publication of the odometry pose + world points + logged values
    through Notifier channels (the pub/sub analog of ROS topics),
  * on failure: dump the initial frame, current map and failing frame as PLY
    for postmortem, then stop (cxx:208-246).

Use together with odometry/concurrent.py's PrefetchIterator/Actor for a fully
asynchronous input pipeline. The node's odometry runs on the card unless
``device`` names another (with no card it raises, as
``ct_icp_torch.resolve_device`` does); the world points it publishes stay
on that device, as the reference hands over its device arrays.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

from ct_icp_torch.config.options import OdometryOptions
from ct_icp_torch.io.ply import write_ply_xyzt
from ct_icp_torch.odometry.concurrent import Notifier
from ct_icp_torch.odometry.odometry import Odometry, RegistrationSummary


@dataclasses.dataclass
class OnlineOdometryConfig:
    odometry_options: OdometryOptions = dataclasses.field(
        default_factory=OdometryOptions)
    expected_frame_period: float = 0.1    # seconds; <=0 disables gating
    check_timestamp_consistency: bool = True
    consistency_ratio_min: float = 0.95   # reference cxx:151
    consistency_ratio_max: float = 1.05
    failure_output_dir: Optional[str] = None
    stop_on_failure: bool = True


class OnlineOdometry:
    """Streaming odometry node: feed scans, observe poses."""

    def __init__(self, config: OnlineOdometryConfig, device=None):
        self.config = config
        self.odometry = Odometry(config.odometry_options, device=device)
        self.pose_output = Notifier()       # ~ /ct_icp/odom
        self.points_output = Notifier()     # ~ /ct_icp/world_points
        self.monitor_output = Notifier()    # ~ /monitor/entry (logged values)
        self.stopped = False
        self._frame_count = 0
        self._last_timestamp: Optional[float] = None
        self._initial_frame: Optional[tuple] = None

    def on_pointcloud(self, xyz: np.ndarray, timestamps: np.ndarray
                      ) -> Optional[RegistrationSummary]:
        """Process one incoming scan; returns the summary (None if gated)."""
        if self.stopped:
            return None
        cfg = self.config

        # ---- timestamp-consistency gate (reference cxx:134-165)
        t0 = float(np.min(timestamps))
        if (cfg.check_timestamp_consistency and cfg.expected_frame_period > 0
                and self._last_timestamp is not None):
            r_dt = (t0 - self._last_timestamp) / cfg.expected_frame_period
            if not (cfg.consistency_ratio_min <= r_dt
                    <= cfg.consistency_ratio_max):
                self.monitor_output.notify(
                    {"event": "frame_dropped", "r_dt": r_dt})
                self._last_timestamp = t0
                return None
        self._last_timestamp = t0

        if self._initial_frame is None:
            self._initial_frame = (np.array(xyz), np.array(timestamps))

        summary = self.odometry.register_frame(
            xyz, timestamps, frame_id=self._frame_count)
        self._frame_count += 1

        if not summary.success:
            self._on_failure(xyz, timestamps, summary)
            return summary

        self.pose_output.notify({
            "frame_id": self._frame_count - 1,
            "begin_pose": summary.frame.begin_pose.copy(),
            "end_pose": summary.frame.end_pose.copy(),
        })
        if summary.corrected_points is not None:
            # (world [S, 3], valid [S]) device tensors, not read back here
            self.points_output.notify(summary.corrected_points)
        self.monitor_output.notify(dict(summary.logged_values))
        return summary

    def _on_failure(self, xyz, timestamps, summary: RegistrationSummary):
        """Reference cxx:208-246: dump initial frame, map (through
        ``get_map_points``, K10) and failing frame."""
        self.monitor_output.notify(
            {"event": "failure", "message": summary.error_message})
        out = self.config.failure_output_dir
        if out:
            out = Path(out)
            out.mkdir(parents=True, exist_ok=True)
            if self._initial_frame is not None:
                write_ply_xyzt(out / "initial_frame.ply",
                               self._initial_frame[0], self._initial_frame[1])
            write_ply_xyzt(out / "frame.ply", xyz, timestamps)
            map_pts = self.odometry.get_map_points(0)
            if map_pts.shape[0]:
                write_ply_xyzt(out / "map.ply", map_pts[:, :3])
        if self.config.stop_on_failure:
            self.stopped = True


# ---------------------------------------------------------------------------
# node analogs of the remaining ROS executables (transport = Notifier)

class DatasetPublisher:
    """Publishes dataset frames at the dataset rate — the ROS dataset node
    analog (reference ros/.../ct_icp_dataset_node.cxx): iterate a sequence,
    notify each frame as (xyz, timestamps, frame_id) on ``output``, sleeping
    to hold ``rate_hz``. ``step()`` publishes one frame (for manual
    pumping); ``run()`` publishes until exhausted or ``stop()``."""

    def __init__(self, sequence, rate_hz: float = 10.0):
        self.sequence = sequence
        self.rate_hz = rate_hz
        self.output = Notifier()
        self.stopped = False
        self._frame_id = 0

    def step(self) -> bool:
        if self.stopped or not self.sequence.has_next():
            return False
        fr = self.sequence.next_frame()
        self.output.notify({"frame_id": self._frame_id,
                            "xyz": fr["xyz"],
                            "timestamps": fr.get("timestamps")})
        self._frame_id += 1
        return True

    def run(self):
        import time as _t
        period = 1.0 / self.rate_hz if self.rate_hz > 0 else 0.0
        nxt = _t.monotonic()
        while self.step():
            nxt += period
            delay = nxt - _t.monotonic()
            if delay > 0:
                _t.sleep(delay)

    def stop(self):
        self.stopped = True


class EvaluationNode:
    """Online trajectory evaluation — the ROS evaluation node analog
    (reference ros/.../ct_icp_evaluation_node.cxx): collects estimated
    poses from a pose Notifier, holds the ground-truth trajectory, and a
    background thread periodically computes KITTI-style metrics, notifying
    them on ``metrics_output``."""

    def __init__(self, ground_truth_poses, period_sec: float = 5.0):
        """``ground_truth_poses``: [N, 4, 4] or list of Pose (absolute)."""
        import threading
        self.gt = ground_truth_poses
        self.period_sec = period_sec
        self.metrics_output = Notifier()
        self._poses = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    def on_pose(self, msg):
        """Subscribe this to OnlineOdometry.pose_output."""
        with self._lock:
            self._poses.append((msg["frame_id"], msg["end_pose"]))

    def compute_metrics(self) -> Optional[dict]:
        from ct_icp_torch.evaluation.kitti import evaluate_matrices
        with self._lock:
            poses = list(self._poses)
        if len(poses) < 2:
            return None
        est = [p.matrix() if hasattr(p, "matrix") else np.asarray(p)
               for _, p in poses]
        n = min(len(est), len(self.gt))
        gt = [g.matrix() if hasattr(g, "matrix") else np.asarray(g)
              for g in self.gt[:n]]
        m = evaluate_matrices(gt, est[:n])
        self.metrics_output.notify(m)
        return m

    def start(self):
        import threading

        def loop():
            while not self._stop.wait(self.period_sec):
                try:
                    self.compute_metrics()
                except Exception as e:      # keep the node alive (ROS-like)
                    self.metrics_output.notify({"error": repr(e)})

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
