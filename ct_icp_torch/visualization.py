"""Visualization export — the viz3d capability as file artifacts; the
port's counterpart of ``ct_icp_tpu/visualization.py``.

The reference's optional VTK/ImGui windows (reference include/SlamCore-viz3d/,
include/ct_icp-viz3d/, ShowAggregatedFramesCallback) stream aggregated clouds,
poses and the map into a GUI. Headless GPU hosts have no GUI; the same
capability here is periodic artifact export: aggregated world-frame clouds,
trajectory and map snapshots as PLY files any viewer (CloudCompare, Open3D,
meshlab) opens directly.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ct_icp_torch.io.ply import save_poses_as_ply, write_ply, write_ply_xyzt


class AggregatedFramesDump:
    """Odometry callback: periodically dump the aggregated registered clouds
    (the ShowAggregatedFramesCallback analog, reference
    ct_icp-viz3d/odometry_callbacks). Register for FINISHED_REGISTRATION."""

    def __init__(self, output_dir, period: int = 50,
                 max_points_per_frame: int = 20000):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.period = period
        self.max_points_per_frame = max_points_per_frame
        self._clouds = []
        self._count = 0

    def __call__(self, odometry, summary, keypoints=None) -> bool:
        if summary is None or summary.corrected_points is None:
            return True
        world, valid = summary.corrected_points
        # one read of the frame's corrected points from the device (the
        # reference's np.asarray of its device arrays)
        host = torch.cat([world, valid[:, None].to(world.dtype)],
                         dim=1).cpu().numpy()
        pts = host[host[:, 3] != 0, :3]
        if pts.shape[0] > self.max_points_per_frame:
            pts = pts[:: pts.shape[0] // self.max_points_per_frame + 1]
        self._clouds.append(pts + odometry.origin)
        self._count += 1
        if self._count % self.period == 0:
            self.flush(odometry)
        return True

    def flush(self, odometry):
        if self._clouds:
            agg = np.concatenate(self._clouds)
            write_ply_xyzt(self.output_dir / f"aggregated_{self._count:06d}.ply",
                           agg)
            self._clouds = []
        traj = odometry.get_trajectory()
        if traj:
            save_poses_as_ply(
                self.output_dir / "trajectory.ply",
                np.stack([f.end_pose.tr for f in traj]))


def export_map_ply(odometry, path, level: int = 0):
    """Dump one map level with normals as PLY (reference GetMapPoints export,
    map.h:354-380)."""
    data = odometry.get_map_points(level)
    if data.shape[0] == 0:
        return
    write_ply(path, {
        "x": data[:, 0].astype(np.float32),
        "y": data[:, 1].astype(np.float32),
        "z": data[:, 2].astype(np.float32),
        "nx": data[:, 3].astype(np.float32),
        "ny": data[:, 4].astype(np.float32),
        "nz": data[:, 5].astype(np.float32),
    })
