"""The port's host IO against ct_icp_tpu's: PLY files (binary and ASCII,
float and double properties) written by each package and read by the
other, the KITTI and CT trajectory formats both ways, the native and the
pure-Python readers against each other, and the NCLT stream decode against
the reference-semantics oracle (``native/libref_oracle.so``, as
tests/test_decoder_differential.py uses it). Tolerance: bit for bit
throughout (files byte for byte, arrays with ``assert_array_equal``)."""

import ctypes
import struct
from pathlib import Path

import numpy as np
import pytest

from ct_icp_torch.core.pose import Pose as TPose
from ct_icp_torch.core.pose import TrajectoryFrame as TFrame
from ct_icp_torch.datasets import dataset as TD
from ct_icp_torch.io import native as tnative
from ct_icp_torch.io import ply as tply
from ct_icp_torch.io import trajectory_io as ttio
from ct_icp_tpu.core.pose import Pose as JPose
from ct_icp_tpu.core.pose import TrajectoryFrame as JFrame
from ct_icp_tpu.datasets import dataset as JD
from ct_icp_tpu.io import ply as jply
from ct_icp_tpu.io import trajectory_io as jtio

REPO = Path(__file__).resolve().parent.parent
WRITERS = {"port": tply, "ref": jply}


def _cloud(seed, n=257):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=30.0, size=(n, 3)), rng.uniform(0, 0.1, n)


def _pure_xyzt(mod, path):
    """read_ply_xyzt's pure-Python path (named columns skip the native
    decoder)."""
    return mod.read_ply_xyzt(path, xyz_names=["x", "y", "z"])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_ply_binary_across_packages(tmp_path, writer, dtype):
    xyz, ts = _cloud(1)
    paths = {}
    for name, mod in WRITERS.items():
        paths[name] = tmp_path / f"{name}.ply"
        mod.write_ply_xyzt(paths[name], xyz, ts, dtype=dtype)
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    path = paths[writer]
    for reader in (tply, jply):
        x2, t2 = _pure_xyzt(reader, path)
        np.testing.assert_array_equal(x2, xyz.astype(dtype).astype(np.float64))
        np.testing.assert_array_equal(t2, ts)
    cols_t, cols_j = tply.read_ply(path), jply.read_ply(path)
    assert list(cols_t) == list(cols_j)
    for k in cols_t:
        assert cols_t[k].dtype == cols_j[k].dtype
        np.testing.assert_array_equal(cols_t[k], cols_j[k])


def test_ply_mixed_columns_and_poses(tmp_path):
    """write_ply of every property type, and save_poses_as_ply: the same
    bytes from both packages, the same columns back."""
    rng = np.random.default_rng(2)
    cols = {"x": rng.normal(size=9).astype(np.float32),
            "t": rng.normal(size=9),
            "i8": rng.integers(-100, 100, 9).astype(np.int8),
            "u8": rng.integers(0, 255, 9).astype(np.uint8),
            "i16": rng.integers(-3000, 3000, 9).astype(np.int16),
            "u16": rng.integers(0, 60000, 9).astype(np.uint16),
            "i32": rng.integers(-10**9, 10**9, 9).astype(np.int32),
            "u32": rng.integers(0, 4 * 10**9, 9).astype(np.uint32)}
    pos = rng.normal(size=(7, 3))
    for name, mod in WRITERS.items():
        mod.write_ply(tmp_path / f"{name}.ply", cols)
        mod.save_poses_as_ply(tmp_path / f"{name}_poses.ply", pos)
    for stem in ("", "_poses"):
        a = (tmp_path / f"port{stem}.ply").read_bytes()
        assert a == (tmp_path / f"ref{stem}.ply").read_bytes()
    back = tply.read_ply(tmp_path / "ref.ply")
    for k, v in cols.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("prop", ["float", "double"])
def test_ply_ascii_across_packages(tmp_path, prop):
    xyz, ts = _cloud(3, n=40)
    lines = [" ".join(repr(float(v)) for v in (*p, t))
             for p, t in zip(xyz, ts)]
    path = tmp_path / "a.ply"
    path.write_text(
        f"ply\nformat ascii 1.0\ncomment made by hand\nelement vertex "
        f"{len(lines)}\nproperty {prop} x\nproperty {prop} y\n"
        f"property {prop} z\nproperty double timestamp\nend_header\n"
        + "\n".join(lines) + "\n")
    xt, tt = tply.read_ply_xyzt(path)      # the native decoder declines
    xj, tj = jply.read_ply_xyzt(path)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(tt, tj)
    # both readers parse ASCII values as float64 whatever the property
    np.testing.assert_array_equal(xt, xyz)
    np.testing.assert_array_equal(tt, ts)


def _poses(seed, pose_cls, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = rng.normal(size=4)
        out.append(pose_cls(q / np.linalg.norm(q), rng.normal(size=3) * 50,
                            float(i) * 0.1 + 0.05, i))
    return out


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_kitti_pose_format_both_ways(tmp_path, writer):
    tp, jp = _poses(4, TPose), _poses(4, JPose)
    ttio.save_poses_kitti_format(tmp_path / "port.txt", tp)
    jtio.save_poses_kitti_format(tmp_path / "ref.txt", jp)
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "ref.txt").read_text()
    path = tmp_path / f"{writer}.txt"
    for a, b in zip(ttio.load_poses_kitti_format(path),
                    jtio.load_poses_kitti_format(path)):
        np.testing.assert_array_equal(a.quat, b.quat)
        np.testing.assert_array_equal(a.tr, b.tr)
        assert (a.timestamp, a.frame_id) == (b.timestamp, b.frame_id)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_ct_trajectory_format_both_ways(tmp_path, writer):
    tp, jp = _poses(5, TPose, 8), _poses(5, JPose, 8)
    tf = [TFrame(a, b) for a, b in zip(tp[::2], tp[1::2])]
    jf = [JFrame(a, b) for a, b in zip(jp[::2], jp[1::2])]
    ttio.save_trajectory_frames(tmp_path / "port.txt", tf)
    jtio.save_trajectory_frames(tmp_path / "ref.txt", jf)
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "ref.txt").read_text()
    path = tmp_path / f"{writer}.txt"
    for a, b in zip(ttio.load_trajectory_frames(path),
                    jtio.load_trajectory_frames(path)):
        for pa, pb in ((a.begin_pose, b.begin_pose), (a.end_pose, b.end_pose)):
            np.testing.assert_array_equal(pa.quat, pb.quat)
            np.testing.assert_array_equal(pa.tr, pb.tr)
            assert (pa.timestamp, pa.frame_id) == (pb.timestamp, pb.frame_id)


def test_native_library_built_from_source():
    """The port compiles native/slamio.cc into build/ct_icp_torch/ and
    loads that copy, never a committed .so."""
    if not tnative.available():
        pytest.skip("no C++ compiler: the port reads PLY in Python")
    lib = tnative._load()
    assert Path(lib._name) == tnative.lib_path()
    assert tnative.lib_path().parent == REPO / "build" / "ct_icp_torch"
    assert "native" not in Path(lib._name).parent.parts


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_time", [True, False])
def test_native_and_python_ply_readers_agree(tmp_path, dtype, with_time):
    if not tnative.available():
        pytest.skip("no C++ compiler: the port reads PLY in Python")
    xyz, ts = _cloud(6, n=1000)
    path = tmp_path / "n.ply"
    tply.write_ply_xyzt(path, xyz, ts if with_time else None, dtype=dtype)
    xn, tn = tnative.ply_read_xyzt(path)
    xp, tp = _pure_xyzt(tply, path)
    np.testing.assert_array_equal(xn, xp)
    if with_time:
        np.testing.assert_array_equal(tn, tp)
    else:
        assert tn is None and tp is None


# ------------------------------------------------------------------ NCLT —

@pytest.fixture(scope="module")
def oracle():
    lib_path = REPO / "native" / "libref_oracle.so"
    if not lib_path.exists():
        pytest.skip("native/libref_oracle.so not built")
    lib = ctypes.CDLL(str(lib_path))
    lib.ref_nclt_decode.restype = ctypes.c_long
    return lib


def _nclt_stream(rng, num_batches):
    out = bytearray()
    for b in range(num_batches):
        num_hits = int(rng.integers(0, 60))
        out += struct.pack("<4H", 44444, 44444, 44444, 44444)
        out += struct.pack("<IQI", num_hits, 1326030000000000 + b * 100_000,
                           int(rng.integers(0, 2**32)))
        for _ in range(num_hits):
            out += struct.pack("<3H2B", *rng.integers(0, 65536, 3),
                               *rng.integers(0, 256, 2))
    return bytes(out)


def _oracle_nclt(lib, stream, num_aggregated, max_frames=64):
    cap = 1 << 16
    xyz = np.zeros((cap, 3), np.float64)
    ts = np.zeros((cap,), np.float64)
    sizes = np.zeros((max_frames,), np.int64)
    n = lib.ref_nclt_decode(
        stream, ctypes.c_long(len(stream)), ctypes.c_int(num_aggregated),
        ctypes.c_int(max_frames),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(cap),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    assert n >= 0
    total = int(sizes[:n].sum())
    return [s for s in sizes[:n].tolist() if s > 0], xyz[:total], ts[:total]


def _decode(mod, root, stream, num_aggregated, native):
    seq = "2012-01-08"
    d = root / f"{seq}_vel" / seq
    d.mkdir(parents=True, exist_ok=True)
    (d / "velodyne_hits.bin").write_bytes(stream)
    it = mod.NCLTIterator(root, seq, num_aggregated_pc=num_aggregated)
    if not native:
        it._native = None
    frames = []
    while it.has_next():
        try:
            frames.append(it._next_unfiltered())
        except StopIteration:
            break
    return frames


@pytest.mark.parametrize("native", [False, True])
def test_nclt_decode_matches_oracle_and_reference(oracle, tmp_path, native):
    if native and not tnative.available():
        pytest.skip("no C++ compiler: the port decodes NCLT in Python")
    rng = np.random.default_rng(21 + native)
    for trial in range(4):
        stream = _nclt_stream(rng, int(rng.integers(1, 12)))
        agg = int(rng.integers(1, 5))
        sizes, xyz_ref, ts_ref = _oracle_nclt(oracle, stream, agg)
        port = _decode(TD, tmp_path / f"p{trial}", stream, agg, native)
        ref = _decode(JD, tmp_path / f"r{trial}", stream, agg, False)
        assert [f["xyz"].shape[0] for f in port] == sizes
        assert [f["xyz"].shape[0] for f in ref] == sizes
        if not port:
            continue
        for frames in (port, ref):
            np.testing.assert_array_equal(
                np.concatenate([f["xyz"] for f in frames]), xyz_ref)
            np.testing.assert_array_equal(
                np.concatenate([f["timestamps"] for f in frames]), ts_ref)
