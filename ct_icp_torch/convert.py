"""Carry state across from ``ct_icp_tpu`` without importing it.

* :func:`map_state_from_numpy` builds the port's map from the reference's
  ``MapLevel`` fields given as numpy arrays (``win``, derived TPU probe
  layout, is dropped).
* :func:`options_from_dict` builds the port's ``OdometryOptions`` (or any
  options dataclass) from ``dataclasses.asdict`` of the reference's.
* :func:`ct_ba_from_numpy` / :func:`ct_ba_to_numpy` carry a CT-BA state
  and problem (``parallel/ct_ba.py``) across as numpy arrays.
* :func:`map_state_to_numpy` gives a port map's levels as numpy arrays in
  the reference's layout (uint32 keys).
* :func:`frame_ring_from_numpy` / :func:`frame_ring_to_numpy` carry a frame
  ring (``mapping/frame_ring.py``) across; :func:`map_points_to_numpy`
  splits an exported level (``Odometry.get_map_points``) into its points
  and normals.
* :func:`sharded_map_from_numpy` / :func:`sharded_map_to_numpy` carry a
  sharded map (``parallel/sharded_map.py``) across in the reference's
  layout, a leading shard axis on every field;
  :func:`write_sharded_checkpoint` / :func:`read_sharded_checkpoint` write
  and read the reference ``DistributedOdometry``'s checkpoint (an .npz and
  a .meta.json).

The parity tests use both so the two packages compute from the same state.

* :func:`convert_sequence` writes a dataset sequence as a PLY_DIRECTORY
  (``frame_%05d.ply`` with per-point timestamps; counterpart of
  ``ct_icp_tpu/convert.py::convert_sequence``);
  :func:`convert_structured_stream` a stream of structured point arrays
  (the PointCloud2 analog, ``io/structured.py``); :func:`bag_to_ply` a
  rosbag 2.0 file's PointCloud2 and Imu messages (``io/rosbag.py``), the
  reference's rosbag_to_ply node. These write files and need no device.

    python -m ct_icp_torch.convert --bag drive.bag --output-dir out/ \
        [--topic /points] [--max-frames N]
    python -m ct_icp_torch.convert --dataset NCLT --root-path /data/nclt \
        --output-dir out/ [--sequence 2012-01-08] [--max-frames N]
"""

import argparse
import dataclasses
import enum
import json
import struct
import typing
from pathlib import Path

import numpy as np
import torch

from ct_icp_torch.config import options as opt
from ct_icp_torch.core.pose import Pose, TrajectoryFrame
from ct_icp_torch.io import rosbag as rb
from ct_icp_torch.io.ply import write_ply, write_ply_xyzt
from ct_icp_torch.io.structured import structured_to_frame
from ct_icp_torch.mapping.frame_ring import FrameRing
from ct_icp_torch.mapping.voxel_map import MapLevel
from ct_icp_torch.parallel.ct_ba import CTBAProblem, CTBAState

_LEVEL_FIELDS = ("keys", "count", "points", "normals", "nflags", "num_points")


def _fields(level):
    if isinstance(level, dict):
        return level
    if hasattr(level, "_asdict"):
        return level._asdict()
    return {f: getattr(level, f) for f in _LEVEL_FIELDS}


def map_state_from_numpy(levels, device="cpu"):
    """Sequence of levels (mappings or NamedTuples of array-likes with the
    reference MapLevel fields) -> tuple of port ``MapLevel``s on ``device``.
    uint32 keys keep their bit pattern as int32."""
    out = []
    for level in levels:
        f = _fields(level)
        keys = np.ascontiguousarray(np.asarray(f["keys"]).astype(np.uint32))
        out.append(MapLevel(
            keys=torch.tensor(keys.view(np.int32), device=device),
            count=torch.tensor(np.asarray(f["count"], np.int32),
                                  device=device),
            points=torch.tensor(np.asarray(f["points"], np.float32),
                                   device=device),
            normals=torch.tensor(np.asarray(f["normals"], np.float32),
                                    device=device),
            nflags=torch.tensor(np.asarray(f["nflags"], np.int32),
                                   device=device),
            num_points=torch.tensor(
                np.asarray(f["num_points"], np.int32).reshape(1),
                device=device)))
    return tuple(out)


def _build(tp, value):
    origin = typing.get_origin(tp)
    if origin is typing.Union:                      # Optional[X]
        if value is None:
            return None
        inner = [a for a in typing.get_args(tp) if a is not type(None)]
        return _build(inner[0], value)
    if origin in (tuple, list):
        args = typing.get_args(tp)
        item = args[0] if args else typing.Any
        return tuple(_build(item, v) for v in value)
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        return options_from_dict(value, tp)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp(getattr(value, "value", value))
    return value


def options_from_dict(d, cls=opt.OdometryOptions):
    """``dataclasses.asdict`` of a reference options object -> the port's
    ``cls`` (nested dataclasses and enums rebuilt by value)."""
    hints = typing.get_type_hints(cls)
    kwargs = {f.name: _build(hints[f.name], d[f.name])
              for f in dataclasses.fields(cls) if f.name in d}
    return cls(**kwargs)


def _named_fields(x, names):
    if isinstance(x, dict):
        return [x[n] for n in names]
    return [getattr(x, n) for n in names]


def ct_ba_from_numpy(state, problem, device="cpu"):
    """A CT-BA state and problem (the reference's NamedTuples, or mappings,
    of array-likes with the same fields) -> the port's (``CTBAState``,
    ``CTBAProblem``) of float32 tensors on ``device``."""
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return (CTBAState(*(f32(a) for a in _named_fields(
                state, CTBAState._fields))),
            CTBAProblem(*(f32(a) for a in _named_fields(
                problem, CTBAProblem._fields))))


def ct_ba_to_numpy(x):
    """A port ``CTBAState`` or ``CTBAProblem`` -> {field: numpy array}."""
    return {n: v.detach().cpu().numpy() for n, v in x._asdict().items()}


def map_state_to_numpy(levels):
    """Port ``MapLevel``s -> list of {field: numpy array} in the reference's
    layout (keys uint32, num_points a scalar), copies: the inserts update
    a level in place."""
    out = []
    for level in levels:
        d = {f: getattr(level, f).detach().cpu().numpy().copy()
             for f in _LEVEL_FIELDS}
        d["keys"] = d["keys"].view(np.uint32)
        d["num_points"] = d["num_points"].reshape(())
        out.append(d)
    return out


def _pose(p) -> Pose:
    """A pose-like (``quat``, ``tr``, ``timestamp``, ``frame_id`` as
    attributes or keys) -> a port ``Pose``."""
    f = p if isinstance(p, dict) else {
        k: getattr(p, k) for k in ("quat", "tr", "timestamp", "frame_id")}
    return Pose(np.array(f["quat"], np.float64), np.array(f["tr"], np.float64),
                float(f["timestamp"]), int(f["frame_id"]))


def frame_ring_from_numpy(frames, max_frames: int) -> FrameRing:
    """Ordered (frame_id, record) pairs, oldest first, each record holding
    ``xyz``, ``timestamps``, ``begin_pose`` and ``end_pose`` (pose-likes, or
    the mappings :func:`frame_ring_to_numpy` gives) -> a port
    ``FrameRing`` of ``max_frames`` holding them."""
    ring = FrameRing(max_frames)
    for fid, rec in frames:
        ring.push(fid, np.array(rec["xyz"]), np.array(rec["timestamps"]),
                  TrajectoryFrame(_pose(rec["begin_pose"]),
                                  _pose(rec["end_pose"])))
    return ring


def frame_ring_to_numpy(ring: FrameRing):
    """A port ``FrameRing`` -> [(frame_id, record)], oldest first: the raw
    scan, the timestamps, the poses as mappings and the world points."""
    out = []
    for fid in ring.frame_ids():
        rec = ring.get_frame(fid)
        out.append((fid, {
            "xyz": rec["xyz"], "timestamps": rec["timestamps"],
            "world": rec["world"],
            **{k: {"quat": rec[k].quat, "tr": rec[k].tr,
                   "timestamp": rec[k].timestamp,
                   "frame_id": rec[k].frame_id}
               for k in ("begin_pose", "end_pose")}}))
    return out


def map_points_to_numpy(points_normals):
    """An exported level, [N, 6] float64 -> (points [N, 3], normals
    [N, 3])."""
    pn = np.asarray(points_normals, np.float64)
    return pn[:, 0:3], pn[:, 3:6]


def sharded_map_from_numpy(levels, rank: int, device="cpu"):
    """Levels with a leading shard axis (mappings or NamedTuples of the
    reference ``MapLevel`` fields, ``[n, ...]`` each) -> rank ``rank``'s
    shard as a tuple of port ``MapLevel``s on ``device``."""
    return map_state_from_numpy(
        [{f: np.asarray(_fields(level)[f])[rank] for f in _LEVEL_FIELDS}
         for level in levels], device)


def sharded_map_to_numpy(shards):
    """Each rank's levels as :func:`map_state_to_numpy` gives them, in rank
    order -> the reference's layout: a {field: [n, ...]} per level, keys
    uint32."""
    return [{f: np.stack([r[i][f] for r in shards]) for f in _LEVEL_FIELDS}
            for i in range(len(shards[0]))]


def _checkpoint_base(path) -> str:
    base = str(path)
    return base[:-4] if base.endswith(".npz") else base


def write_sharded_checkpoint(path, shards, trajectory, registered: int):
    """The reference ``DistributedOdometry.save_checkpoint``'s files from
    each rank's levels (:func:`sharded_map_to_numpy`'s input) and the
    trajectory (``TrajectoryFrame``s): ``level{i}_{field}`` with a leading
    shard axis (no ``win``), ``trajectory`` [F, 18], and the .meta.json."""
    base = _checkpoint_base(path)
    Path(base).parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for i, level in enumerate(sharded_map_to_numpy(shards)):
        for f, v in level.items():
            arrays[f"level{i}_{f}"] = v
    arrays["trajectory"] = np.stack([
        np.concatenate([
            f.begin_pose.quat, f.begin_pose.tr,
            [f.begin_pose.timestamp, float(f.begin_pose.frame_id)],
            f.end_pose.quat, f.end_pose.tr,
            [f.end_pose.timestamp, float(f.end_pose.frame_id)]])
        for f in trajectory]) if trajectory else np.zeros((0, 18))
    np.savez_compressed(base + ".npz", **arrays)
    meta = {"registered": int(registered), "num_levels": len(shards[0]),
            "num_shards": len(shards)}
    Path(base + ".meta.json").write_text(json.dumps(meta))


def read_sharded_checkpoint(path):
    """Read a ``DistributedOdometry`` checkpoint (the reference's or the
    port's): (levels, a {field: [n, ...]} each; the trajectory as port
    ``TrajectoryFrame``s; the meta dict)."""
    base = _checkpoint_base(path)
    meta = json.loads(Path(base + ".meta.json").read_text())
    with np.load(base + ".npz") as data:
        levels = [{f: data[f"level{i}_{f}"] for f in _LEVEL_FIELDS}
                  for i in range(meta["num_levels"])]
        rows = data["trajectory"]
    trajectory = [TrajectoryFrame(
        Pose(row[0:4], row[4:7], float(row[7]), int(row[8])),
        Pose(row[9:13], row[13:16], float(row[16]), int(row[17])))
        for row in rows]
    return levels, trajectory, meta


def convert_sequence(sequence, output_dir, max_frames: int = -1,
                     pattern: str = "frame_{:05d}.ply") -> int:
    """Drain ``sequence`` (has_next/next_frame) into ``output_dir``."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    i = 0
    while sequence.has_next() and (max_frames < 0 or i < max_frames):
        fr = sequence.next_frame()
        write_ply_xyzt(out / pattern.format(i),
                       np.asarray(fr["xyz"], np.float32),
                       fr.get("timestamps"))
        i += 1
    return i


def convert_structured_stream(arrays, output_dir, max_frames: int = -1,
                              pattern: str = "frame_{:05d}.ply") -> int:
    """Write an iterable of structured point arrays (PointCloud2 analogs)
    as a PLY directory."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    i = 0
    for arr in arrays:
        if max_frames >= 0 and i >= max_frames:
            break
        xyz, ts = structured_to_frame(arr)
        write_ply_xyzt(out / pattern.format(i), np.asarray(xyz, np.float32),
                       ts)
        i += 1
    return i


def bag_to_ply(bag_path, output_dir, topic=None, max_frames: int = -1,
               pattern: str = "frame_{:05d}.ply") -> int:
    """A rosbag 2.0 file's PointCloud2 stream (and Imu stream) as the
    PLY_DIRECTORY layout, in one pass over the bag (reference
    rosbag_to_ply.cxx:109-180; ``ct_icp_tpu/convert.py::bag_to_ply``):
    frames in ``output_dir/frames/`` with per-point timestamps rebased so
    the first cloud's minimum is 0, the header stamp relative to the first
    message for clouds without a timestamp field, and the IMU samples in
    ``output_dir/imu_data.ply``. Returns the number of frames written."""
    root = Path(output_dir)
    out = root / "frames"
    out.mkdir(parents=True, exist_ok=True)
    i = 0
    t0_header = None   # first message header stamp (initial_nano_seconds)
    t0_points = None   # first cloud's min point timestamp
    imu = []
    for msg in rb.read_bag(bag_path):
        if msg.msg_type == "sensor_msgs/Imu":
            imu.append(rb.parse_imu(msg.raw))
            continue
        if msg.msg_type and msg.msg_type != "sensor_msgs/PointCloud2":
            continue
        if topic is not None and msg.topic != topic:
            continue
        if max_frames >= 0 and i >= max_frames:
            continue  # keep draining for IMU samples
        try:
            pc = rb.parse_pointcloud2(msg.raw)
        except (ValueError, struct.error, IndexError):
            if msg.msg_type == "sensor_msgs/PointCloud2":
                raise
            continue  # an untyped connection that was not a point cloud
        stamp = pc.stamp
        xyz, ts = structured_to_frame(pc.to_structured())
        if t0_header is None:
            t0_header = stamp
        if ts is not None:
            if t0_points is None:
                t0_points = float(np.min(ts)) if len(ts) else stamp
            ts = np.asarray(ts, np.float64) - t0_points
        else:
            ts = np.full(len(xyz), stamp - t0_header, np.float64)
        write_ply_xyzt(out / pattern.format(i), np.asarray(xyz, np.float32),
                       ts)
        i += 1

    if imu and t0_header is None:
        # no clouds in the bag: rebase the IMU to its own first sample
        t0_header = imu[0].stamp
    if imu:
        columns = {"timestamp": np.array([s.stamp - t0_header for s in imu])}
        for field, names in (("orientation", ("qx", "qy", "qz", "qw")),
                             ("angular_velocity", ("wx", "wy", "wz")),
                             ("linear_acceleration", ("ax", "ay", "az"))):
            for j, name in enumerate(names):
                columns[name] = np.array([getattr(s, field)[j] for s in imu])
        write_ply(root / "imu_data.ply", columns)
    return i


def main(argv=None):
    from ct_icp_torch.datasets.dataset import (Dataset, DatasetEnum,
                                               DatasetOptions)
    p = argparse.ArgumentParser(
        description="Convert any supported dataset or a rosbag to a PLY "
                    "directory (rosbag_to_ply analog)")
    p.add_argument("--dataset", default=None,
                   help="Dataset type (NCLT, KITTI_raw, SYNTHETIC, ...)")
    p.add_argument("--bag", default=None,
                   help="rosbag 2.0 file with PointCloud2 messages")
    p.add_argument("--topic", default=None,
                   help="PointCloud2 topic to convert (with --bag)")
    p.add_argument("--root-path", default=None)
    p.add_argument("--sequence", default=None, help="Only this sequence")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--max-frames", type=int, default=-1)
    args = p.parse_args(argv)

    if args.bag is not None:
        n = bag_to_ply(args.bag, args.output_dir,
                       topic=args.topic, max_frames=args.max_frames)
        print(f"[{args.bag}] wrote {n} frames -> {args.output_dir}")
        return 0 if n else 1
    if args.dataset is None or args.root_path is None:
        p.error("either --bag or --dataset + --root-path is required")

    ds = Dataset.load_dataset(DatasetOptions(
        dataset=DatasetEnum[args.dataset], root_path=args.root_path))
    total = 0
    for seq in ds.sequences:
        name = getattr(seq, "name", None) or getattr(seq, "sequence_name", "")
        if args.sequence and name != args.sequence:
            continue
        out = Path(args.output_dir) / name / "frames" if name \
            else Path(args.output_dir)
        n = convert_sequence(seq, out, args.max_frames)
        print(f"[{name or 'sequence'}] wrote {n} frames -> {out}")
        total += n
    return 0 if total else 1


if __name__ == "__main__":
    raise SystemExit(main())
