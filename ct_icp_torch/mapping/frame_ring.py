"""Host-side retention of the last N inserted frame clouds.

Counterpart of ``ct_icp_tpu/mapping/frame_ring.py`` (the reference map's
frame store, ``MultipleResolutionVoxelMap::frame_id_to_frame`` with
``Options::max_frames_to_keep``, reference include/ct_icp/map.h:154-253).
Each inserted frame keeps its raw scan (numpy, already on the host) and its
(begin, end) poses; world points are computed on demand by the continuous
transform (``Pose.continuous_transform``, float64). The ring holds no
device tensor, so filling it costs the streaming path no device read.
Only inserted frames are retained, as in the reference.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np

from ct_icp_torch.core.pose import Pose, TrajectoryFrame


class FrameRing:
    """Ring of the last ``max_frames`` inserted frame clouds."""

    def __init__(self, max_frames: int):
        self.max_frames = int(max_frames)
        self._frames: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._frames)

    @property
    def enabled(self) -> bool:
        return self.max_frames > 0

    def frame_ids(self) -> List[int]:
        return list(self._frames.keys())

    def push(self, frame_id: int, xyz: np.ndarray, timestamps: np.ndarray,
             frame: TrajectoryFrame) -> None:
        """Retain one inserted frame; the oldest frames past ``max_frames``
        are dropped (reference map.h:246-253)."""
        if not self.enabled:
            return
        ts = np.asarray(timestamps, np.float64)
        self._frames[int(frame_id)] = {
            "xyz": np.asarray(xyz),
            "timestamps": ts,
            "begin_pose": frame.begin_pose.copy(),
            "end_pose": frame.end_pose.copy(),
            "min_t": float(ts.min()) if ts.size else 0.0,
            "max_t": float(ts.max()) if ts.size else 0.0,
        }
        while len(self._frames) > self.max_frames:
            self._frames.popitem(last=False)

    def get_frame(self, frame_id: int, world: bool = True
                  ) -> Optional[Dict[str, np.ndarray]]:
        """One retained frame (None if it is not retained); with
        ``world=True`` also its world points under its retained poses
        (reference pointcloud.h:249-264)."""
        rec = self._frames.get(int(frame_id))
        if rec is None:
            return None
        out = dict(rec)
        if world:
            bp: Pose = rec["begin_pose"]
            out["world"] = bp.continuous_transform(
                rec["xyz"], rec["end_pose"], rec["timestamps"])
        return out

    def update_trajectory(self, frames: List[TrajectoryFrame]) -> None:
        """Re-point the retained poses at an updated trajectory (reference
        ISlamMap::UpdateTrajectory, map.h:64-70), matched by the end pose's
        frame id."""
        by_id = {}
        for f in frames:
            fid = f.end_pose.frame_id
            if fid is not None and fid >= 0:
                by_id[int(fid)] = f
        for fid, rec in self._frames.items():
            f = by_id.get(fid)
            if f is not None:
                rec["begin_pose"] = f.begin_pose.copy()
                rec["end_pose"] = f.end_pose.copy()

    def all_world_points(self) -> np.ndarray:
        """The world points of every retained frame, oldest first."""
        parts = [self.get_frame(fid)["world"] for fid in self._frames]
        if not parts:
            return np.zeros((0, 3), np.float64)
        return np.concatenate(parts, axis=0)

    def clear(self) -> None:
        self._frames.clear()
