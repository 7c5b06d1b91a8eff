"""Rendered synthetic frames as the runner's inputs (numpy only; both
packages' runners read them, so chip_smoke.py and the JAX package's CPU
reference, ``tests/torch_runner_reference.py``, run the same files and
frames).

* :func:`mid_frame_ground_truth`: a frame's ground truth as the runner
  grades it, the pose halfway through the frame, relative to the first
  frame's begin pose (where the odometry starts), at the frame's mid
  timestamp.
* :func:`write_kitti_sequence` writes frames in the KITTI layout the
  dataset readers discover (``<root>/<name>/frames/frame_%05d.ply`` with
  per-point timestamps, and ``<root>/<name>/<name>.txt``, the ground truth
  in the KITTI pose format). The reader conjugates KITTI poses by the
  sequence's velodyne calibration and stamps pose i at (i + 0.5) x 0.1 s
  (``datasets/dataset.py::load_kitti_gt``): the poses are written
  conjugated the other way, so that the reader gives them back. A
  PLY_DIRECTORY reads no ground truth (``Dataset.load_dataset``), so a run
  that is graded takes this layout, run as ``--dataset KITTI``.
* :class:`FrameSequence`: a list of frames (or a ``frame(i)`` callable) as
  a dataset sequence with that ground truth, for ``run_sequence``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from ct_icp_torch.core.pose import Pose
from ct_icp_torch.datasets.dataset import (ADatasetSequence, SequenceInfo,
                                           kitti_calib)
from ct_icp_torch.io.ply import write_ply_xyzt
from ct_icp_torch.io.trajectory_io import save_poses_kitti_format


def mid_frame_ground_truth(frames) -> List[Pose]:
    """Each frame's mid pose relative to frame 0's begin pose, stamped at
    the middle of the frame's begin and end pose timestamps."""
    first_inv = frames[0]["begin_pose"].inverse()
    out = []
    for i, fr in enumerate(frames):
        b, e = first_inv * fr["begin_pose"], first_inv * fr["end_pose"]
        mid = b.interpolate_alpha(e, 0.5)
        mid.timestamp = 0.5 * (fr["begin_pose"].timestamp
                               + fr["end_pose"].timestamp)
        mid.frame_id = i
        out.append(mid)
    return out


def write_kitti_sequence(frames, root, name: str = "00",
                         workers: int = 8) -> Path:
    """Write ``frames`` (dicts with xyz, timestamps, begin_pose, end_pose)
    as KITTI sequence ``name`` under ``root``; returns the sequence's
    directory. The points are written as float32, the timestamps as
    float64, as ``convert.convert_sequence`` writes them."""
    seq_dir = Path(root) / name
    frames_dir = seq_dir / "frames"
    frames_dir.mkdir(parents=True, exist_ok=True)

    def write(i):
        fr = frames[i]
        write_ply_xyzt(frames_dir / f"frame_{i:05d}.ply",
                       np.asarray(fr["xyz"], np.float32), fr["timestamps"])

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(write, range(len(frames))))
    calib = kitti_calib(int(name))
    calib_inv = np.linalg.inv(calib)
    save_poses_kitti_format(seq_dir / f"{name}.txt", [
        Pose.from_matrix(calib @ p.matrix() @ calib_inv)
        for p in mid_frame_ground_truth(frames)])
    return seq_dir


class FrameSequence(ADatasetSequence):
    """Frames already rendered (a list, or ``frame(i)`` over
    ``num_frames``) as a dataset sequence whose ground truth is ``gt``
    (default :func:`mid_frame_ground_truth` of the frames)."""

    def __init__(self, frames=None, name: str = "frames",
                 frame: Optional[Callable[[int], dict]] = None,
                 num_frames: Optional[int] = None, gt=None):
        self._frame = frame if frame is not None else frames.__getitem__
        self._n = len(frames) if num_frames is None else num_frames
        super().__init__(SequenceInfo(sequence_name=name,
                                      sequence_size=self._n,
                                      with_ground_truth=True))
        self._gt = gt if gt is not None else mid_frame_ground_truth(
            [self._frame(i) for i in range(self._n)])

    def num_frames(self) -> int:
        return self._n

    def with_random_access(self) -> bool:
        return True

    def has_next(self) -> bool:
        last = self._n
        if self.max_num_frames > 0:
            last = min(last, self.init_frame_id + self.max_num_frames)
        return self.current_frame_id < last

    def ground_truth(self) -> List[Pose]:
        return self._gt

    def _get_unfiltered(self, index: int) -> dict:
        return dict(self._frame(index))

    def _next_unfiltered(self) -> dict:
        frame = self._get_unfiltered(self.current_frame_id)
        self.current_frame_id += 1
        return frame
