"""Checkpoint / resume for the odometry state (counterpart of
``ct_icp_tpu/odometry/checkpoint.py``).

The full odometry state is written in the reference's layout, so that a
checkpoint of either package loads into the other: ``<base>.npz`` holds
``level{i}_{field}`` (the map, keys as uint32, no ``win``), ``trajectory``
[F, 18] and ``origin``; ``<base>.meta.json`` holds the counters, the
insertion tracker, and as pickles in hex the numpy RNG's state and the
default motion model's previous frame.

The streamed path's device odometry state is not in the files. The load
rebuilds it from the trajectory, as the reference's robust streamer does
(``Odometry._odo_state_from_host``), and then puts back the device's own
float32 quaternions: the host trajectory holds each one normalized in
float64 (``Pose.normalize_``), and :func:`_device_quat` finds the one
float32 quaternion within three ulps a component whose float64
normalization is that value. A streamed run resumed from a checkpoint of
the port then continues bit for bit.

The previous frame is pickled as a ``TrajectoryFrame``. A checkpoint of
``ct_icp_tpu`` names that package's ``Pose`` and ``TrajectoryFrame``:
:class:`_Unpickler` maps exactly those two classes to the port's own (the
same dataclass fields), so that loading never imports the JAX package, and
refuses every class but them and numpy's array reconstruction.
"""

from __future__ import annotations

import io
import json
import pickle
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

import torch

from ct_icp_torch import convert
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.pose import Pose, TrajectoryFrame

if TYPE_CHECKING:
    from ct_icp_torch.odometry.odometry import Odometry

FORMAT_VERSION = 1

_POSE_CLASSES = {"Pose": Pose, "TrajectoryFrame": TrajectoryFrame}
_POSE_MODULES = ("ct_icp_tpu.core.pose", "ct_icp_torch.core.pose")
# what a pickled numpy array or scalar names (numpy 1 and 2)
_NUMPY_NAMES = {(m, n) for m in ("numpy.core.multiarray",
                                 "numpy._core.multiarray")
                for n in ("_reconstruct", "scalar")} | {
    ("numpy", "ndarray"), ("numpy", "dtype")}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _POSE_MODULES and name in _POSE_CLASSES:
            return _POSE_CLASSES[name]
        if (module, name) in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint: refusing to unpickle {module}.{name}")


def _loads(hex_text: str):
    return _Unpickler(io.BytesIO(bytes.fromhex(hex_text))).load()


def _device_quat(q64):
    """The float32 quaternion whose float64 normalization is ``q64`` bit
    for bit, searched within three ulps of ``q64`` a component (a norm
    within float32's epsilon of 1, as the device's quaternions keep); None
    where there is none (a quaternion that was not a float32 one
    normalized on the host, e.g. one the reference wrote)."""
    q64 = np.asarray(q64, np.float64)
    base = q64.astype(np.float32).view(np.int32)
    steps = np.arange(-3, 4, dtype=np.int32)
    grid = np.stack(np.meshgrid(*[base[i] + steps for i in range(4)],
                                indexing="ij"), -1).reshape(-1, 4)
    cands = grid.view(np.float32)
    screened = cands[(s3n.quat_normalize(cands.astype(np.float64))
                      == q64).all(axis=1)]
    # each hit confirmed as the host normalizes one quaternion
    hits = [c for c in screened if np.array_equal(
        s3n.quat_normalize(c.astype(np.float64)), q64)]
    return hits[0] if len(hits) == 1 else None


def _odo_state(odometry) -> torch.Tensor:
    """The streamed path's device state rebuilt from the restored
    trajectory and tracker, with the device's float32 quaternions."""
    s = odometry._odo_state_from_host().cpu().numpy()
    k = odometry.registered_frames
    # pipeline.py's ODO_STATE layout: the last frame's begin and
    # end quaternions at 0 and 7, the one before it's at 14 and 21
    for base, fid in ((0, k - 1), (14, k - 2)):
        if fid < 0:
            continue
        frame = odometry.trajectory[fid]
        for off, pose in ((0, frame.begin_pose), (7, frame.end_pose)):
            q = _device_quat(pose.quat)
            if q is not None:
                s[base + off:base + off + 4] = q
    return torch.as_tensor(s, device=odometry.device)


def _base_path(path) -> str:
    """Checkpoint base name: '.npz' stripped so save('x') / load('x.npz')
    (and vice versa) find the same pair of files."""
    base = str(path)
    return base[:-4] if base.endswith(".npz") else base


def _pose_row(p: Pose):
    return [p.quat, p.tr, [p.timestamp], [float(p.frame_id)]]


def save_checkpoint(odometry: "Odometry", path) -> None:
    """Write the full odometry state to ``path`` (an .npz + sidecar json)."""
    path = Path(_base_path(path))
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for i, level in enumerate(convert.map_state_to_numpy(odometry.map_state)):
        for name in convert._LEVEL_FIELDS:
            arrays[f"level{i}_{name}"] = level[name]
    arrays["trajectory"] = np.array([
        np.concatenate(_pose_row(f.begin_pose) + _pose_row(f.end_pose))
        for f in odometry.trajectory
    ]).reshape(-1, 18) if odometry.trajectory else np.zeros((0, 18))
    arrays["origin"] = odometry.origin
    tracker = odometry.insertion_tracker
    meta = {
        "format_version": FORMAT_VERSION,
        "num_levels": len(odometry.map_state),
        "registered_frames": odometry.registered_frames,
        "robust_num_consecutive_failures":
            odometry.robust_num_consecutive_failures,
        "suspect_registration_error": odometry.suspect_registration_error,
        "next_robust_level": odometry.next_robust_level,
        "insertion_tracker": {
            "last_inserted_frame_idx": tracker.last_inserted_frame_idx,
            "cum_distance_since_insertion":
                tracker.cum_distance_since_insertion,
            "cum_orientation_change_since_insertion":
                tracker.cum_orientation_change_since_insertion,
            "skipped_frames": tracker.skipped_frames,
            "total_insertions": tracker.total_insertions,
        },
        "rng_state": None,  # stored via pickle below (BitGenerator state dict)
    }
    np.savez_compressed(str(path) + ".npz", **arrays)
    Path(str(path) + ".meta.json").write_text(json.dumps(meta | {
        "rng": pickle.dumps(odometry.rng.bit_generator.state).hex(),
        "prev_frame": pickle.dumps(
            odometry.default_motion_model.previous_frame).hex()}))


def load_checkpoint(odometry: "Odometry", path) -> None:
    """Restore state written by :func:`save_checkpoint` (of either package)
    into ``odometry``, on its device. The device odometry state of the
    streamed path is rebuilt from the restored trajectory and tracker
    (:func:`_odo_state`); the frames and scans pending in a stream and the
    frame ring start empty."""
    path = Path(_base_path(path))
    sidecar = json.loads(Path(str(path) + ".meta.json").read_text())
    if sidecar["format_version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {sidecar['format_version']}, "
                         f"expected {FORMAT_VERSION}")
    with np.load(str(path) + ".npz") as data:
        levels = [{name: data[f"level{i}_{name}"]
                   for name in convert._LEVEL_FIELDS}
                  for i in range(sidecar["num_levels"])]
        rows = data["trajectory"]
        origin = np.asarray(data["origin"], np.float64)
    if len(levels) != len(odometry.map_state):
        raise ValueError(f"checkpoint has {len(levels)} map levels, the "
                         f"odometry {len(odometry.map_state)}")
    odometry.map_state = convert.map_state_from_numpy(
        levels, device=odometry.device)
    odometry.trajectory = [TrajectoryFrame(
        Pose(row[0:4], row[4:7], float(row[7]), int(row[8])),
        Pose(row[9:13], row[13:16], float(row[16]), int(row[17])))
        for row in rows]
    odometry.origin = origin
    odometry.registered_frames = sidecar["registered_frames"]
    odometry.robust_num_consecutive_failures = \
        sidecar["robust_num_consecutive_failures"]
    odometry.suspect_registration_error = sidecar["suspect_registration_error"]
    odometry.next_robust_level = sidecar["next_robust_level"]
    for k, v in sidecar["insertion_tracker"].items():
        setattr(odometry.insertion_tracker, k, v)
    odometry.rng.bit_generator.state = _loads(sidecar["rng"])
    odometry.default_motion_model.previous_frame = _loads(
        sidecar["prev_frame"])
    odometry.frame_ring.clear()
    odometry._pending_scans.clear()
    odometry._pending_worlds.clear()
    odometry._pending_kp.clear()
    odometry._prune_owed = False
    odometry._odo_state = _odo_state(odometry)
