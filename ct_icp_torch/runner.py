"""OdometryRunner — per-sequence odometry loop with metrics and outputs.

Counterpart of the reference runner (reference command/odometry_runner.{h,cpp}):
iterates every sequence of every configured dataset, feeds frames to the
odometry, periodically computes KITTI metrics against ground truth, saves
mid-frame interpolated poses and the CT trajectory, and writes
``metrics.yaml`` per run (reference SaveTrajectoryAndMetrics,
odometry_runner.cpp:318-365).

Counterpart of ``ct_icp_tpu/runner.py``. The odometry runs on ``device``
(the card unless the caller asks for the CPU); the dataset, the prefetch
and the outputs are host work.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ct_icp_torch.config.yaml_config import RunnerConfig
from ct_icp_torch.core.pose import Pose, TrajectoryFrame
from ct_icp_torch.core.trajectory import LinearContinuousTrajectory
from ct_icp_torch.datasets.dataset import (ADatasetSequence, Dataset,
                                         is_driving_dataset)
from ct_icp_torch.evaluation import kitti as ev
from ct_icp_torch.io.ply import save_poses_as_ply
from ct_icp_torch.io.trajectory_io import (save_poses_kitti_format,
                                         save_trajectory_frames)
from ct_icp_torch.odometry.odometry import Odometry


@dataclasses.dataclass
class SequenceResult:
    name: str
    num_frames: int = 0
    finished: bool = False
    success: bool = True
    avg_runtime_ms: float = 0.0
    metrics: Optional[ev.SeqErrors] = None
    trajectory_metrics: Optional[object] = None  # TrajectoryMetrics


def mid_frame_poses(trajectory: List[TrajectoryFrame]) -> List[Pose]:
    """Mid-scan interpolated poses (reference odometry_runner.cpp:318-340)."""
    out = []
    for fr in trajectory:
        p = fr.begin_pose.interpolate_alpha(fr.end_pose, 0.5)
        p.timestamp = 0.5 * (fr.begin_pose.timestamp + fr.end_pose.timestamp)
        out.append(p)
    return out


class OdometryRunner:
    def __init__(self, config: RunnerConfig, device=None):
        self.config = config
        self.device = device
        self.output_dir: Optional[Path] = None
        if config.output_results:
            base = Path(config.output_dir)
            if config.generate_directory_prefix:
                base = base / time.strftime("%Y-%m-%d_%H-%M-%S")
            base.mkdir(parents=True, exist_ok=True)
            self.output_dir = base
        self.results: Dict[str, SequenceResult] = {}

    def run(self) -> bool:
        ok = True
        for ds_options in self.config.dataset_options:
            dataset = Dataset.load_dataset(ds_options)
            driving = is_driving_dataset(ds_options.dataset)
            seq_filters = {
                s.get("sequence_name"): s for s in ds_options.sequence_options
            } if ds_options.sequence_options else None
            for seq in dataset.sequences:
                name = seq.seq_info.sequence_name
                if seq_filters is not None and name not in seq_filters:
                    continue
                if seq_filters and seq_filters.get(name):
                    so = seq_filters[name]
                    if "init_frame" in so:
                        seq.set_init_frame(int(so["init_frame"]))
                    if "max_num_frames" in so:
                        seq.set_max_num_frames(int(so["max_num_frames"]))
                result = self.run_sequence(seq, driving=driving)
                self.results[name] = result
                ok = ok and result.success
                if not result.success and self.config.exit_early:
                    return False
        if self.output_dir is not None:
            self._write_metrics_yaml()
        return ok

    def run_sequence(self, seq: ADatasetSequence, driving: bool = True,
                     odometry: Optional[Odometry] = None) -> SequenceResult:
        name = seq.seq_info.sequence_name
        odo = odometry or Odometry(self.config.odometry_options,
                                   device=self.device)
        result = SequenceResult(name=name)
        if self.config.max_frames > 0:
            seq.set_max_num_frames(self.config.max_frames)

        runtimes = []
        fid = 0

        # prefetch pipeline: the host preparation of the next scans (dedup,
        # keypoint partition, packing) in worker threads while the device
        # registers the current one
        from ct_icp_torch.odometry.concurrent import PrefetchIterator

        robust_stream = (not odo._use_fused
                         and odo.options.robust_registration
                         and odo._fused_available)

        def _prepare(item):
            i, frame = item
            ts = (frame["timestamps"] if frame.get("timestamps") is not None
                  else np.zeros(frame["xyz"].shape[0]))
            # the reference's upload= / pad_rung= arguments pin XLA program
            # shapes; the port's prepare_frame has no compiled shapes to pin
            # and uploads in the register or stream step
            return odo.prepare_frame(frame["xyz"], ts, registered_fid=i,
                                     frame_id=i)

        def summaries():
            prepared = PrefetchIterator(enumerate(seq), depth=2,
                                        transform=_prepare)
            if odo._use_fused:
                # streaming: dispatch frame k before reading k-1's result
                # (device-resident motion init/tracker, odometry.stream_frames)
                yield from odo.stream_frames(prepared)
            elif robust_stream:
                # speculative robust streaming: batched robust-level-0
                # attempts, rollback+per-frame replay on failed assessment
                yield from odo.stream_frames(prepared, batch=4)
            else:
                for prep in prepared:
                    yield odo.register_frame_prepared(prep)

        t_prev = time.time()
        try:
            for summary in summaries():
                now = time.time()
                runtimes.append(now - t_prev)
                t_prev = now
                if not summary.success:
                    print(f"[{name}] frame {fid} FAILED: "
                          f"{summary.error_message}", file=sys.stderr)
                    result.success = False
                    if self.config.exit_early:
                        break
                fid += 1
                if self.config.progress_bar and fid % 20 == 0:
                    avg = float(np.mean(runtimes[-20:])) * 1000
                    print(f"[{name}] frame {fid}  avg {avg:.1f} ms/frame",
                          flush=True)
                if (self.config.compute_metrics_period > 0
                        and fid % self.config.compute_metrics_period == 0):
                    self._save_sequence_outputs(name, seq, odo, driving,
                                                result)
        except ValueError as e:
            # a degenerate frame (e.g. every return non-finite) raises from
            # prepare/register; fail the sequence but keep the registered
            # prefix and its outputs/metrics rather than killing the run
            print(f"[{name}] frame {fid} ABORTED: {e}", file=sys.stderr)
            result.success = False

        result.num_frames = fid
        result.finished = not seq.has_next()
        result.avg_runtime_ms = float(np.mean(runtimes)) * 1000 if runtimes else 0.0
        self._save_sequence_outputs(name, seq, odo, driving, result)
        return result

    # ------------------------------------------------------------- outputs —
    def _save_sequence_outputs(self, name, seq, odo: Odometry, driving,
                               result: SequenceResult):
        trajectory = odo.get_trajectory()
        if not trajectory:
            return
        mids = mid_frame_poses(trajectory)
        gt = seq.ground_truth()
        if gt is not None and len(trajectory) > 1:
            est_traj = LinearContinuousTrajectory(mids, check_sorted=True)
            gt_slice = [p for p in gt if p.frame_id < len(trajectory)] \
                if any(p.frame_id >= 0 for p in gt) else gt[:len(trajectory)]
            est = None
            if len(gt_slice) > 1:
                try:
                    # interpolate once; both metric families reuse it
                    est = [est_traj.interpolate_pose(p.timestamp, clip=True)
                           for p in gt_slice]
                    result.metrics = ev.evaluate_poses(gt_slice, est, driving)
                    result.metrics.average_elapsed_ms = result.avg_runtime_ms
                except Exception as e:  # metrics must never kill the run
                    print(f"[{name}] metrics failed: {e}", file=sys.stderr)
            if est is not None and len(gt_slice) > 5:
                # segment-ATE trajectory metrics alongside the KITTI RPE
                # (reference ComputeTrajectoryMetrics, eval.cxx:184-292)
                try:
                    from ct_icp_torch.evaluation.trajectory_metrics import (
                        compute_trajectory_metrics)
                    seg_len = 100.0 if driving else 10.0
                    result.trajectory_metrics = compute_trajectory_metrics(
                        gt_slice, est, segment_length=seg_len)
                except Exception as e:
                    print(f"[{name}] trajectory metrics failed: {e}",
                          file=sys.stderr)
        if self.output_dir is None:
            return
        seq_dir = self.output_dir / name
        seq_dir.mkdir(parents=True, exist_ok=True)
        save_trajectory_frames(seq_dir / f"{name}_ct_trajectory.txt", trajectory)
        save_poses_kitti_format(seq_dir / f"{name}.txt", mids)
        save_poses_as_ply(seq_dir / "trajectory.ply",
                          np.stack([p.tr for p in mids]))
        if getattr(self.config, "html_viewer", False):
            try:
                from ct_icp_torch.viewer import export_odometry_html
                export_odometry_html(odo, seq_dir / "viewer.html",
                                     title=f"{name} map")
            except Exception as e:  # viewer must never kill the run
                print(f"[{name}] viewer export failed: {e}", file=sys.stderr)

    def _write_metrics_yaml(self):
        metrics = {name: r.metrics for name, r in self.results.items()
                   if r.metrics is not None}
        have_traj = any(r.trajectory_metrics is not None
                        for r in self.results.values())
        if not metrics and not have_traj:
            return
        text = ev.generate_metrics_yaml(metrics) if metrics else ""
        for name, r in self.results.items():
            if r.trajectory_metrics is not None:
                from ct_icp_torch.evaluation.trajectory_metrics import (
                    generate_trajectory_metrics_yaml)
                body = generate_trajectory_metrics_yaml(r.trajectory_metrics)
                text += f'"{name}_trajectory":\n' + "".join(
                    f"  {line}\n" for line in body.strip().splitlines())
        with open(self.output_dir / "metrics.yaml", "w") as f:
            f.write(text)
        print(f"Saved metrics to {self.output_dir / 'metrics.yaml'}")
