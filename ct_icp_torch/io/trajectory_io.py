"""Trajectory / pose file formats.

Host copy of ``ct_icp_tpu/io/trajectory_io.py`` (numpy only, nothing of the JAX
package imported).

  * CT trajectory text format (reference src/ct_icp/io.cpp:31-95): one line
    per frame = begin pose then end pose, each as
    ``dest_frame_id dest_timestamp ref_frame_id ref_timestamp qx qy qz qw tx ty tz``
    (quaternion in Eigen coefficient order x y z w).
  * KITTI pose format (reference LoadPosesKITTIFormat, io.h:235): one line per
    pose = the 12 row-major entries of the top 3x4 of the 4x4 matrix.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ct_icp_torch.core.pose import Pose, TrajectoryFrame


def _pose_to_tokens(p: Pose) -> List[str]:
    q = p.quat  # internal (w, x, y, z) -> file order (x, y, z, w)
    return ([str(p.frame_id), repr(float(p.timestamp)), "0", "0"]
            + [repr(float(v)) for v in (q[1], q[2], q[3], q[0])]
            + [repr(float(v)) for v in p.tr])


def save_trajectory_frames(path, trajectory: Sequence[TrajectoryFrame]) -> bool:
    with open(path, "w") as f:
        for fr in trajectory:
            toks = _pose_to_tokens(fr.begin_pose) + _pose_to_tokens(fr.end_pose)
            f.write(" ".join(toks) + "\n")
    return True


def load_trajectory_frames(path) -> List[TrajectoryFrame]:
    frames = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            assert len(tok) == 22, f"Invalid trajectory line: {len(tok)} tokens"

            def parse(off):
                fid = int(float(tok[off]))
                ts = float(tok[off + 1])
                qx, qy, qz, qw = (float(v) for v in tok[off + 4:off + 8])
                tr = np.array([float(v) for v in tok[off + 8:off + 11]])
                return Pose(np.array([qw, qx, qy, qz]), tr, ts, fid)

            frames.append(TrajectoryFrame(parse(0), parse(11)))
    return frames


def save_poses_kitti_format(path, poses: Sequence[Pose]):
    with open(path, "w") as f:
        for p in poses:
            m = p.matrix()
            f.write(" ".join(repr(float(v)) for v in m[:3, :].reshape(-1)) + "\n")


def load_poses_kitti_format(path) -> List[Pose]:
    out = []
    for i, line in enumerate(open(path)):
        vals = [float(v) for v in line.split()]
        if not vals:
            continue
        m = np.eye(4)
        m[:3, :] = np.asarray(vals[:12]).reshape(3, 4)
        out.append(Pose.from_matrix(m, timestamp=float(i), frame_id=i))
    return out
