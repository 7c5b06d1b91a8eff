"""Pure-python rosbag v2.0 reader for LiDAR bags; the port's own copy of
``ct_icp_tpu/io/rosbag.py`` (host numpy).

The missing half of the reference's rosbag->PLY tool (reference
ros/catkin_ws/slam_roscore/src/rosbag_to_ply.cxx): that node subscribes to
live ``sensor_msgs/PointCloud2`` + ``sensor_msgs/Imu`` topics and dumps
them as a PLY directory; this module reads the same messages straight out
of an on-disk ``.bag`` file (rosbag format 2.0) with no ROS installation,
yielding numpy structured arrays — the package's PointCloud2 analog
(io/structured.py) — that ``convert.py`` turns into the PLY_DIRECTORY
layout every other tool consumes.

Format reference: the rosbag 2.0 container is a sequence of records
``<u32 header_len><header><u32 data_len><data>`` where the header is a
list of ``<u32 len>name=value`` fields; message payloads live inside
chunk records (compression none/bz2; an lz4 chunk raises
NotImplementedError: the port carries no lz4 decoder, and the reference
raises the same where the lz4 package is absent). Message bodies use
standard ROS serialization (little-endian, packed, strings as u32-length +
bytes).
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

# record ops (rosbag format 2.0)
OP_MESSAGE_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

# sensor_msgs/PointField datatype codes -> numpy dtypes
POINTFIELD_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}

_U32 = struct.Struct("<I")


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    """Parse a record header: sequence of ``<u32 len>name=value`` fields."""
    fields: Dict[bytes, bytes] = {}
    pos = 0
    while pos < len(buf):
        (flen,) = _U32.unpack_from(buf, pos)
        pos += 4
        item = buf[pos:pos + flen]
        pos += flen
        name, _, value = item.partition(b"=")
        fields[name] = value
    return fields


def _read_record(f) -> Optional[Tuple[Dict[bytes, bytes], bytes]]:
    raw = f.read(4)
    if len(raw) < 4:
        return None
    (hlen,) = _U32.unpack(raw)
    header = _parse_header(f.read(hlen))
    (dlen,) = _U32.unpack(f.read(4))
    data = f.read(dlen)
    if len(data) < dlen:
        raise ValueError("truncated rosbag record")
    return header, data


@dataclass
class Connection:
    conn_id: int
    topic: str
    msg_type: str = ""
    md5sum: str = ""


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    #: bag-record receive time in seconds (header stamp of the transport)
    time: float
    #: raw serialized ROS message body
    raw: bytes


def _iter_records_in(data: bytes) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    pos = 0
    n = len(data)
    while pos < n:
        (hlen,) = _U32.unpack_from(data, pos)
        pos += 4
        header = _parse_header(data[pos:pos + hlen])
        pos += hlen
        (dlen,) = _U32.unpack_from(data, pos)
        pos += 4
        yield header, data[pos:pos + dlen]
        pos += dlen


def read_bag(path) -> Iterator[BagMessage]:
    """Stream every message record of a rosbag 2.0 file in file order.

    Handles uncompressed and bz2 chunks, and bags written without chunking
    (bare connection/message records at top level).
    """
    connections: Dict[int, Connection] = {}

    def _handle(header: Dict[bytes, bytes], data: bytes):
        op = header[b"op"][0]
        if op == OP_CONNECTION:
            conn_id = _U32.unpack(header[b"conn"])[0]
            sub = _parse_header(data)
            connections[conn_id] = Connection(
                conn_id,
                header.get(b"topic", sub.get(b"topic", b"")).decode(),
                sub.get(b"type", b"").decode(),
                sub.get(b"md5sum", b"").decode())
        elif op == OP_MESSAGE_DATA:
            conn_id = _U32.unpack(header[b"conn"])[0]
            secs, nsecs = struct.unpack("<II", header[b"time"])
            conn = connections.get(conn_id)
            if conn is None:
                raise ValueError(f"message for unknown connection {conn_id}")
            return BagMessage(conn.topic, conn.msg_type,
                              secs + nsecs * 1e-9, data)
        return None

    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(
                f"not a rosbag 2.0 file (magic {magic!r}); rosbag 1.x and "
                "ROS2 (sqlite3/mcap) containers are not supported")
        while True:
            rec = _read_record(f)
            if rec is None:
                break
            header, data = rec
            op = header[b"op"][0]
            if op == OP_CHUNK:
                compression = header.get(b"compression", b"none")
                if compression == b"bz2":
                    data = bz2.decompress(data)
                elif compression == b"lz4":
                    raise NotImplementedError(
                        "lz4-compressed rosbag chunks are not supported "
                        "(no lz4 decoder)")
                elif compression != b"none":
                    raise ValueError(
                        f"unknown chunk compression {compression!r}")
                for sub_header, sub_data in _iter_records_in(data):
                    msg = _handle(sub_header, sub_data)
                    if msg is not None:
                        yield msg
            elif op in (OP_CONNECTION, OP_MESSAGE_DATA):
                msg = _handle(header, data)
                if msg is not None:
                    yield msg
            # bag header / index / chunk-info records: skip


class _Cursor:
    """Little-endian walk over a serialized ROS message body."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        (v,) = _U32.unpack_from(self.buf, self.pos)
        self.pos += 4
        return v

    def f64(self, n: int = 1):
        vals = struct.unpack_from(f"<{n}d", self.buf, self.pos)
        self.pos += 8 * n
        return vals[0] if n == 1 else np.asarray(vals)

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.pos:self.pos + n]
        self.pos += n
        return s.decode(errors="replace")

    def time(self) -> float:
        return self.u32() + self.u32() * 1e-9

    def raw(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b


@dataclass
class PointCloud2:
    stamp: float
    frame_id: str
    height: int
    width: int
    #: (name, offset, numpy dtype, count) per field
    fields: List[Tuple[str, int, type, int]]
    is_bigendian: bool
    point_step: int
    row_step: int
    data: bytes
    is_dense: bool

    def to_structured(self) -> np.ndarray:
        """Expose the packed point buffer as a numpy structured array
        (zero-copy over the message bytes) — the PointCloud2 analog the
        rest of the package consumes (io/structured.py)."""
        names, formats, offsets = [], [], []
        for name, off, np_dtype, count in self.fields:
            names.append(name)
            formats.append(np_dtype if count == 1 else (np_dtype, (count,)))
            offsets.append(off)
        dt = np.dtype({"names": names, "formats": formats,
                       "offsets": offsets, "itemsize": self.point_step})
        if self.is_bigendian:
            dt = dt.newbyteorder(">")
        n = self.height * self.width
        if self.height > 1 and self.row_step != self.width * self.point_step:
            # padded rows: gather each row's packed prefix
            rows = [np.frombuffer(self.data,
                                  dt, self.width, r * self.row_step)
                    for r in range(self.height)]
            return np.concatenate(rows)
        return np.frombuffer(self.data, dt, n)


def parse_pointcloud2(raw: bytes) -> PointCloud2:
    """Deserialize a sensor_msgs/PointCloud2 body."""
    c = _Cursor(raw)
    c.u32()  # header.seq
    stamp = c.time()
    frame_id = c.string()
    height, width = c.u32(), c.u32()
    nfields = c.u32()
    fields = []
    for _ in range(nfields):
        name = c.string()
        offset = c.u32()
        datatype = c.u8()
        count = c.u32()
        np_dtype = POINTFIELD_DTYPES.get(datatype)
        if np_dtype is None:
            raise ValueError(f"bad PointField datatype {datatype}")
        fields.append((name, offset, np_dtype, count))
    is_bigendian = bool(c.u8())
    point_step = c.u32()
    row_step = c.u32()
    data = c.raw(c.u32())
    is_dense = bool(c.u8())
    return PointCloud2(stamp, frame_id, height, width, fields, is_bigendian,
                       point_step, row_step, data, is_dense)


@dataclass
class ImuSample:
    stamp: float
    orientation: np.ndarray        # [4] xyzw
    angular_velocity: np.ndarray   # [3]
    linear_acceleration: np.ndarray  # [3]


def parse_imu(raw: bytes) -> ImuSample:
    """Deserialize a sensor_msgs/Imu body."""
    c = _Cursor(raw)
    c.u32()  # header.seq
    stamp = c.time()
    c.string()  # frame_id
    orientation = c.f64(4)
    c.f64(9)  # orientation_covariance
    angular_velocity = c.f64(3)
    c.f64(9)
    linear_acceleration = c.f64(3)
    c.f64(9)
    return ImuSample(stamp, orientation, angular_velocity,
                     linear_acceleration)


def iter_pointclouds(path, topic: Optional[str] = None
                     ) -> Iterator[Tuple[float, np.ndarray]]:
    """Yield ``(stamp_seconds, structured_points)`` per PointCloud2 message
    on ``topic`` (or on every PointCloud2 topic if None)."""
    for msg in read_bag(path):
        if msg.msg_type and msg.msg_type != "sensor_msgs/PointCloud2":
            continue
        if topic is not None and msg.topic != topic:
            continue
        try:
            pc = parse_pointcloud2(msg.raw)
        except (ValueError, struct.error, IndexError):
            # IndexError: a truncated body can fail in _Cursor.u8 (bytes
            # indexing) before any struct unpack runs
            if msg.msg_type == "sensor_msgs/PointCloud2":
                raise
            continue  # untyped connection that wasn't a point cloud
        yield pc.stamp, pc.to_structured()


def iter_imu(path, topic: Optional[str] = None) -> Iterator[ImuSample]:
    for msg in read_bag(path):
        if msg.msg_type != "sensor_msgs/Imu":
            continue
        if topic is not None and msg.topic != topic:
            continue
        yield parse_imu(msg.raw)
