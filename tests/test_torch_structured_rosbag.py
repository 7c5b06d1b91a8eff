"""The port's structured-array conversions, rosbag 2.0 reader and bag
converter (``ct_icp_torch/io/structured.py``, ``io/rosbag.py``,
``convert.py``'s ``bag_to_ply``, ``convert_structured_stream`` and
``main``) against ct_icp_tpu's on the same inputs: both are numpy host
code, so every output is equal bit for bit and every file byte for byte.
The bags are written with tests/test_rosbag.py's helpers (uncompressed and
bz2 chunks, no chunks, padded rows, big-endian, IMU only, a non-bag and an
lz4 chunk, which raises NotImplementedError in both packages: neither
carries an lz4 decoder); the port's own writer
(``ct_icp_torch/tools/bag_writer.py``) gives the same bytes as those
helpers."""

import bz2
import struct

import numpy as np
import pytest

from ct_icp_torch import convert as tconv
from ct_icp_torch.io import rosbag as trb
from ct_icp_torch.io import structured as tst
from ct_icp_torch.tools import bag_writer as bw
from ct_icp_tpu import convert as jconv
from ct_icp_tpu.io import rosbag as jrb
from ct_icp_tpu.io import structured as jst
from tests.test_rosbag import (_connection, _imu_body, _message,
                               _pointcloud2_body, _record, _string)

PC2 = b"sensor_msgs/PointCloud2"


def _clouds(n=3, points=50, seed=7, t0=100.0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        xyz = rng.uniform(-10, 10, (points, 3)).astype(np.float32)
        ts = t0 + i * 0.1 + np.linspace(0, 0.1, points)
        out.append((xyz, ts, t0 + i * 0.1))
    return out


def _stamp_ns(t):
    secs = int(t)
    return secs, int(round((t - secs) * 1e9))


def _cloud_records(clouds, conn=0):
    return [_message(conn, *_stamp_ns(s), _pointcloud2_body(xyz, ts, s))
            for xyz, ts, s in clouds]


def _imu_records(n, conn=1, t0=100.05):
    return [_message(conn, *_stamp_ns(t0 + 0.1 * i),
                     _imu_body(t0 + 0.1 * i, (0, 0, 0.1 * i, 1),
                               (0.1, 0, i), (0, 0, 9.81)))
            for i in range(n)]


def _chunk(records, compression=b"none"):
    data = b"".join(records)
    packed = bz2.compress(data) if compression == b"bz2" else data
    return _record({b"op": bytes([jrb.OP_CHUNK]), b"compression": compression,
                    b"size": struct.pack("<I", len(data))}, packed)


def _bag(path, body):
    head = _record({b"op": bytes([jrb.OP_BAG_HEADER]),
                    b"index_pos": struct.pack("<Q", 0),
                    b"conn_count": struct.pack("<I", 0),
                    b"chunk_count": struct.pack("<I", 0)}, b"\x20" * 64)
    path.write_bytes(jrb.MAGIC + head + body)
    return path


def _conns():
    return [_connection(0, b"/ct_icp/pointcloud", PC2),
            _connection(1, b"/imu", b"sensor_msgs/Imu")]


def _raw_cloud_body(arr, fields, height, width, point_step, row_step,
                    bigendian, stamp=5.25):
    """A PointCloud2 body around raw row bytes ``arr``: ``fields`` are
    (name, offset, datatype, count)."""
    body = struct.pack("<I", 0) + struct.pack("<II", *_stamp_ns(stamp))
    body += _string(b"lidar") + struct.pack("<II", height, width)
    body += struct.pack("<I", len(fields))
    for name, off, dtype, count in fields:
        body += _string(name) + struct.pack("<IBI", off, dtype, count)
    body += struct.pack("<B", int(bigendian))
    body += struct.pack("<II", point_step, row_step)
    body += struct.pack("<I", len(arr)) + arr + struct.pack("<B", 1)
    return body


PADDED_XYZ = {False: [], True: []}


def _padded_bigendian_bag(path, bigendian):
    """One cloud of 3 rows of 4 points: x, y, z float32 and an intensity
    uint16, point_step 16, each row padded by 8 bytes."""
    rng = np.random.default_rng(3)
    dt = np.dtype({"names": ["x", "y", "z", "intensity"],
                   "formats": [">f4" if bigendian else "<f4"] * 3
                   + [">u2" if bigendian else "<u2"],
                   "offsets": [0, 4, 8, 12], "itemsize": 16})
    rows = []
    for _ in range(3):
        r = np.zeros(4, dt)
        for n in ("x", "y", "z"):
            r[n] = rng.normal(size=4)
        r["intensity"] = rng.integers(0, 1000, 4)
        rows.append(r.tobytes() + b"\xab" * 8)
        PADDED_XYZ[bigendian].append(np.stack([r[n] for n in "xyz"], -1))
    fields = [(b"x", 0, 7, 1), (b"y", 4, 7, 1), (b"z", 8, 7, 1),
              (b"intensity", 12, 4, 1)]
    body = _raw_cloud_body(b"".join(rows), fields, 3, 4, 16, 72, bigendian)
    return _bag(path, _chunk([_connection(0, b"/points", PC2),
                              _message(0, 5, 250_000_000, body)]))


def _same_messages(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert (x.topic, x.msg_type, x.time, x.raw) == \
            (y.topic, y.msg_type, y.time, y.raw)


def _same_clouds(a, b):
    assert len(a) == len(b)
    for (sa, xa), (sb, xb) in zip(a, b):
        assert sa == sb and xa.dtype == xb.dtype
        assert xa.tobytes() == xb.tobytes()


def _same_imu(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.stamp == y.stamp
        for f in ("orientation", "angular_velocity", "linear_acceleration"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def _same_tree(a, b):
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb and fa
    for f in fa:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _bags(tmp_path):
    clouds = _clouds()
    imu = _imu_records(2)
    conns = _conns()
    return {
        "chunked": _bag(tmp_path / "chunked.bag",
                        _chunk(conns + _cloud_records(clouds[:1]) + imu[:1])
                        + _chunk(_cloud_records(clouds[1:]) + imu[1:],
                                 b"bz2")),
        "unchunked": _bag(tmp_path / "unchunked.bag",
                          b"".join(conns + _cloud_records(clouds) + imu)),
        "imu_only": _bag(tmp_path / "imu.bag",
                         _chunk(conns[1:] + _imu_records(3), b"bz2")),
        "padded": _padded_bigendian_bag(tmp_path / "padded.bag", False),
        "bigendian": _padded_bigendian_bag(tmp_path / "be.bag", True),
    }


@pytest.mark.parametrize("kind", ["chunked", "unchunked", "imu_only",
                                  "padded", "bigendian"])
def test_reader_matches_reference(kind, tmp_path):
    path = _bags(tmp_path)[kind]
    _same_messages(list(trb.read_bag(path)), list(jrb.read_bag(path)))
    clouds = list(trb.iter_pointclouds(path))
    _same_clouds(clouds, list(jrb.iter_pointclouds(path)))
    _same_imu(list(trb.iter_imu(path)), list(jrb.iter_imu(path)))
    if kind in ("padded", "bigendian"):
        (_, arr), = clouds
        xyz, ts = tst.structured_to_frame(arr)
        assert ts is None
        np.testing.assert_array_equal(xyz, np.concatenate(
            PADDED_XYZ[kind == "bigendian"][-3:]))
    if kind == "imu_only":
        assert clouds == [] and len(list(trb.iter_imu(path))) == 3


def test_topic_filter_and_parse_errors(tmp_path):
    path = _bags(tmp_path)["chunked"]
    for topic, n in (("/ct_icp/pointcloud", 3), ("/nothing", 0)):
        clouds = list(trb.iter_pointclouds(path, topic))
        _same_clouds(clouds, list(jrb.iter_pointclouds(path, topic)))
        assert len(clouds) == n
    assert len(list(trb.iter_imu(path, "/imu"))) == 2
    assert list(trb.iter_imu(path, "/other")) == []
    # a message whose connection is unknown, and a truncated cloud
    bad = _bag(tmp_path / "orphan.bag", _message(9, 1, 0, b"x"))
    for rb in (trb, jrb):
        with pytest.raises(ValueError, match="unknown connection"):
            list(rb.read_bag(bad))
    trunc = _bag(tmp_path / "trunc.bag", b"".join(
        [_connection(0, b"/p", PC2), _message(0, 1, 0, b"\x00" * 10)]))
    for rb in (trb, jrb):
        with pytest.raises((struct.error, IndexError, ValueError)):
            list(rb.iter_pointclouds(trunc))


def test_non_bag_and_lz4_raise_in_both(tmp_path):
    p = tmp_path / "x.bag"
    p.write_bytes(b"#ROSBAG V1.2\n junk")
    for rb in (trb, jrb):
        with pytest.raises(ValueError, match="not a rosbag 2.0"):
            list(rb.read_bag(p))
    lz4 = _bag(tmp_path / "lz4.bag", _chunk(_conns(), b"lz4"))
    for rb in (trb, jrb):
        with pytest.raises(NotImplementedError, match="lz4"):
            list(rb.read_bag(lz4))
    odd = _bag(tmp_path / "odd.bag", _chunk(_conns(), b"zstd"))
    for rb in (trb, jrb):
        with pytest.raises(ValueError, match="unknown chunk compression"):
            list(rb.read_bag(odd))


@pytest.mark.parametrize("kind", ["chunked", "unchunked", "imu_only",
                                  "padded"])
def test_bag_to_ply_files_equal_reference(kind, tmp_path):
    path = _bags(tmp_path)[kind]
    n_t = tconv.bag_to_ply(path, tmp_path / "port")
    n_j = jconv.bag_to_ply(path, tmp_path / "ref")
    assert n_t == n_j == {"chunked": 3, "unchunked": 3, "imu_only": 0,
                          "padded": 1}[kind]
    _same_tree(tmp_path / "port", tmp_path / "ref")
    # with a topic and a frame limit: the IMU is still drained
    topic = "/points" if kind == "padded" else "/ct_icp/pointcloud"
    tconv.bag_to_ply(path, tmp_path / "port2", topic=topic, max_frames=1)
    jconv.bag_to_ply(path, tmp_path / "ref2", topic=topic, max_frames=1)
    _same_tree(tmp_path / "port2", tmp_path / "ref2")


def test_convert_main_equal_reference(tmp_path):
    bag = _bags(tmp_path)["chunked"]
    assert tconv.main(["--bag", str(bag), "--output-dir",
                       str(tmp_path / "port")]) == 0
    assert jconv.main(["--bag", str(bag), "--output-dir",
                       str(tmp_path / "ref")]) == 0
    _same_tree(tmp_path / "port", tmp_path / "ref")
    imu = _bags(tmp_path)["imu_only"]
    assert tconv.main(["--bag", str(imu), "--output-dir",
                       str(tmp_path / "i")]) == jconv.main(
        ["--bag", str(imu), "--output-dir", str(tmp_path / "j")]) == 1
    # --dataset: the converted PLY directory, converted again
    for pkg, out in ((tconv, "port_ds"), (jconv, "ref_ds")):
        assert pkg.main(["--dataset", "PLY_DIRECTORY", "--root-path",
                         str(tmp_path / "port"), "--output-dir",
                         str(tmp_path / out), "--max-frames", "2"]) == 0
    _same_tree(tmp_path / "port_ds", tmp_path / "ref_ds")
    with pytest.raises(SystemExit):
        tconv.main(["--output-dir", str(tmp_path / "none")])


def test_structured_round_trip_and_zero_copy():
    rng = np.random.default_rng(0)
    xyz = rng.random((100, 3)).astype(np.float32)
    ts = np.linspace(0.0, 0.1, 100)
    extra = {"intensity": rng.random(100).astype(np.float32)}
    arr = tst.frame_to_structured(xyz, ts, extra=extra)
    ref = jst.frame_to_structured(xyz, ts, extra=extra)
    assert arr.dtype == ref.dtype and arr.tobytes() == ref.tobytes()
    out_xyz, out_ts = tst.structured_to_frame(arr)
    j_xyz, j_ts = jst.structured_to_frame(arr)
    np.testing.assert_array_equal(out_xyz, j_xyz)
    np.testing.assert_array_equal(out_ts, j_ts)
    np.testing.assert_array_equal(out_xyz, xyz)
    # adjacent float32 x/y/z: a strided view of the array's own buffer
    assert np.shares_memory(out_xyz, arr)
    out_xyz[0, 0] = 42.0
    assert arr["x"][0] == 42.0
    np.testing.assert_array_equal(
        tst.select_fields(arr, ["intensity", "x"]),
        jst.select_fields(arr, ["intensity", "x"]))
    # a named time field, a plain [N, >= 3] array, a missing field
    np.testing.assert_array_equal(
        tst.structured_to_frame(arr, time_field="intensity")[1],
        jst.structured_to_frame(arr, time_field="intensity")[1])
    plain = rng.random((5, 4))
    assert np.shares_memory(tst.structured_to_frame(plain)[0], plain)
    for st in (tst, jst):
        with pytest.raises(ValueError, match="missing point field"):
            st.structured_to_frame(np.zeros(3, [("x", "f4"), ("y", "f4")]))
        with pytest.raises(ValueError, match="expected a structured"):
            st.structured_to_frame(np.zeros(4))


def test_structured_nonadjacent_copies():
    dt = np.dtype({"names": ["x", "pad", "y", "z", "t"],
                   "formats": [np.float32, np.int16, np.float32, np.float32,
                               np.float64]})
    arr = np.zeros(10, dtype=dt)
    arr["x"], arr["y"], arr["z"], arr["t"] = 1.0, 2.0, 3.0, np.arange(10)
    xyz, ts = tst.structured_to_frame(arr)
    j_xyz, j_ts = jst.structured_to_frame(arr)
    assert not np.shares_memory(xyz, arr)
    np.testing.assert_array_equal(xyz, j_xyz)
    np.testing.assert_array_equal(ts, j_ts)
    np.testing.assert_array_equal(xyz, np.tile([1.0, 2.0, 3.0], (10, 1)))


def test_convert_structured_stream_equal_reference(tmp_path):
    arrays = [tst.frame_to_structured(xyz, ts)
              for xyz, ts, _ in _clouds(4)]
    assert tconv.convert_structured_stream(
        arrays, tmp_path / "port", max_frames=3) == 3
    assert jconv.convert_structured_stream(
        arrays, tmp_path / "ref", max_frames=3) == 3
    _same_tree(tmp_path / "port", tmp_path / "ref")


def test_bag_writer_matches_the_fixture_helpers(tmp_path):
    """The port's writer (chip_smoke.py's bags) gives the bytes of
    tests/test_rosbag.py's helpers, and a bag the reference reads alike."""
    (xyz, ts, s), = _clouds(1, t0=1.6e9)
    assert bw.pointcloud2_body(xyz, ts, s) == _pointcloud2_body(xyz, ts, s)
    assert bw.imu_body(2.5, (0, 0, 0, 1), (0.1, 0, 0), (0, 0, 9.81)) == \
        _imu_body(2.5, (0, 0, 0, 1), (0.1, 0, 0), (0, 0, 9.81))
    assert bw.connection(0, b"/p", bw.POINTCLOUD2) == \
        _connection(0, b"/p", PC2)
    assert bw.message(3, 100.25, b"abc") == _message(3, 100, 250_000_000,
                                                     b"abc")
    recs = [bw.connection(0, b"/p", bw.POINTCLOUD2),
            bw.message(0, s, bw.pointcloud2_body(xyz, ts, s))]
    for compression in ("none", "bz2", None):
        path = bw.write_bag(tmp_path / f"{compression}.bag",
                            [(compression, recs)])
        _same_clouds(list(trb.iter_pointclouds(path)),
                     list(jrb.iter_pointclouds(path)))
