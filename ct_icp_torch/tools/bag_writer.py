"""A rosbag 2.0 writer for test and smoke data (the inverse of
``io/rosbag.py``): ``sensor_msgs/PointCloud2`` clouds with x, y, z as
float32 and ``timestamp`` as float64 at point_step 24 (4 pad bytes after
z, the layout of ``tests/test_rosbag.py``'s fixture), and
``sensor_msgs/Imu`` samples, in chunk records that are uncompressed or
bz2-compressed, or as bare top-level records (a bag without chunks).

    from ct_icp_torch.tools import bag_writer as bw
    recs = [bw.connection(0, b"/points", bw.POINTCLOUD2),
            bw.message(0, stamp, bw.pointcloud2_body(xyz, ts, stamp))]
    bw.write_bag(path, [("none", recs)])
"""

import bz2
import struct
from pathlib import Path

import numpy as np

from ct_icp_torch.io import rosbag as rb

POINTCLOUD2 = b"sensor_msgs/PointCloud2"
IMU = b"sensor_msgs/Imu"
POINT_STEP = 24
_CLOUD_DTYPE = np.dtype({
    "names": ["x", "y", "z", "timestamp"],
    "formats": [np.float32, np.float32, np.float32, np.float64],
    "offsets": [0, 4, 8, 16], "itemsize": POINT_STEP})
# (name, offset, sensor_msgs/PointField datatype, count)
_CLOUD_FIELDS = ((b"x", 0, 7, 1), (b"y", 4, 7, 1), (b"z", 8, 7, 1),
                 (b"timestamp", 16, 8, 1))


def _header(fields: dict) -> bytes:
    out = b""
    for name, value in fields.items():
        item = name + b"=" + value
        out += struct.pack("<I", len(item)) + item
    return out


def record(fields: dict, data: bytes) -> bytes:
    """One record: ``<u32 header_len><header><u32 data_len><data>``."""
    h = _header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def connection(conn_id: int, topic: bytes, msg_type: bytes) -> bytes:
    sub = _header({b"topic": topic, b"type": msg_type,
                   b"md5sum": b"0" * 32, b"message_definition": b""})
    return record({b"op": bytes([rb.OP_CONNECTION]),
                   b"conn": struct.pack("<I", conn_id), b"topic": topic},
                  sub)


def _stamp(t: float):
    """Seconds -> (secs, nsecs) of a ROS time."""
    return divmod(int(round(t * 1e9)), 1_000_000_000)


def message(conn_id: int, stamp: float, body: bytes) -> bytes:
    return record({b"op": bytes([rb.OP_MESSAGE_DATA]),
                   b"conn": struct.pack("<I", conn_id),
                   b"time": struct.pack("<II", *_stamp(stamp))}, body)


def _string(s: bytes) -> bytes:
    return struct.pack("<I", len(s)) + s


def pointcloud2_body(xyz, ts, stamp: float) -> bytes:
    """A serialized sensor_msgs/PointCloud2 of one row: x, y, z float32 and
    timestamp float64 at point_step 24, little-endian, dense."""
    n = len(xyz)
    buf = np.zeros(n, _CLOUD_DTYPE)
    xyz = np.asarray(xyz)
    buf["x"], buf["y"], buf["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    buf["timestamp"] = ts
    data = buf.tobytes()
    body = struct.pack("<I", 0)                        # header.seq
    body += struct.pack("<II", *_stamp(stamp))         # header.stamp
    body += _string(b"lidar")                          # header.frame_id
    body += struct.pack("<II", 1, n)                   # height, width
    body += struct.pack("<I", len(_CLOUD_FIELDS))
    for name, off, dtype, count in _CLOUD_FIELDS:
        body += _string(name) + struct.pack("<IBI", off, dtype, count)
    body += struct.pack("<B", 0)                       # is_bigendian
    body += struct.pack("<II", POINT_STEP, POINT_STEP * n)
    body += struct.pack("<I", len(data)) + data
    body += struct.pack("<B", 1)                       # is_dense
    return body


def imu_body(stamp: float, quat_xyzw, gyro, accel) -> bytes:
    """A serialized sensor_msgs/Imu (covariances zero)."""
    zeros9 = struct.pack("<9d", *([0.0] * 9))
    body = struct.pack("<I", 0) + struct.pack("<II", *_stamp(stamp))
    body += _string(b"imu")
    body += struct.pack("<4d", *quat_xyzw) + zeros9
    body += struct.pack("<3d", *gyro) + zeros9
    body += struct.pack("<3d", *accel) + zeros9
    return body


def write_bag(path, chunks) -> Path:
    """Write a rosbag 2.0 file: the bag header record, then for each
    ``(compression, records)`` of ``chunks`` one chunk record
    (``compression`` "none" or "bz2") holding the concatenated records, or
    the records at top level where ``compression`` is None."""
    body = b""
    for compression, records in chunks:
        data = b"".join(records)
        if compression is None:
            body += data
            continue
        packed = bz2.compress(data) if compression == "bz2" else data
        body += record({b"op": bytes([rb.OP_CHUNK]),
                        b"compression": compression.encode(),
                        b"size": struct.pack("<I", len(data))}, packed)
    head = record({b"op": bytes([rb.OP_BAG_HEADER]),
                   b"index_pos": struct.pack("<Q", 0),
                   b"conn_count": struct.pack("<I", 0),
                   b"chunk_count": struct.pack("<I", len(chunks))},
                  b"\x20" * 64)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(rb.MAGIC + head + body)
    return path


IMU_PER_FRAME = 10


def write_frames_bag(path, frames, t0: float, compression="none") -> Path:
    """Rendered frames (``xyz``, ``timestamps`` relative to the drive's
    start, ``begin_pose``) as a bag of one chunk a frame on the topics
    /points and /imu: the frame's cloud stamped ``t0`` plus its first
    point's time, its per-point timestamps offset by ``t0``, and
    IMU_PER_FRAME Imu samples across the frame (the begin pose's
    orientation, no rotation rate, gravity)."""
    records = [connection(0, b"/points", POINTCLOUD2),
               connection(1, b"/imu", IMU)]
    chunks = []
    for fr in frames:
        ts = t0 + np.asarray(fr["timestamps"], np.float64)
        stamp = float(ts.min())
        records.append(message(0, stamp, pointcloud2_body(
            np.asarray(fr["xyz"], np.float32), ts, stamp)))
        w, x, y, z = fr["begin_pose"].quat
        for j in range(IMU_PER_FRAME):
            t = stamp + j * (float(ts.max()) - stamp) / IMU_PER_FRAME
            records.append(message(1, t, imu_body(
                t, (x, y, z, w), (0.0, 0.0, 0.0), (0.0, 0.0, 9.81))))
        chunks.append((compression, records))
        records = []
    return write_bag(path, chunks)
