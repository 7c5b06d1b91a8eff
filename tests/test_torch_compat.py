"""The port's pyct_icp binding shim (``ct_icp_torch/compat/pyct_icp.py``)
against ct_icp_tpu's: the enums, constants, POINT3D_DTYPE and LiDARFrame,
the OdometryOptions factories, RegisterFrame / RegisterFrameRaw on 3
frames of tests/test_odometry.py's room (poses within the cross-package
bound, 5 mm and 0.05 deg; map sizes equal), Trajectory, MapSize,
GetLocalMap and Reset, and the dataset helpers on a PLY directory the test
writes (bit for bit: numpy host code in both)."""

import dataclasses

import numpy as np
import pytest
import torch

import ct_icp_torch.compat.pyct_icp as tpy
import ct_icp_tpu.compat.pyct_icp as jpy
from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.datasets.dataset import DatasetEnum as TEnum
from ct_icp_torch.io.ply import write_ply_xyzt
from ct_icp_tpu.datasets.dataset import DatasetEnum as JEnum
from tests.test_odometry import small_options
from tests.torch_surface_cases import (assert_frames_close, frames,
                                       port_options)

NAMES = ("CERES", "GN", "ROBUST", "POINT_TO_PLANE", "POINT_TO_POINT",
         "POINT_TO_LINE", "POINT_TO_DISTRIBUTION", "NONE",
         "CONSTANT_VELOCITY", "ITERATIVE", "CONTINUOUS")
ENUMS = ("CT_ICP_SOLVER", "ICP_DISTANCE", "LEAST_SQUARES",
         "MOTION_COMPENSATION", "INITIALIZATION")


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One torch thread: the plain kernels run many small ops, and the other
    test workers keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_binding_surface():
    for name in NAMES:
        a, b = getattr(tpy, name), getattr(jpy, name)
        assert (a.name, a.value) == (b.name, b.value)
    for name in ENUMS:
        assert [(m.name, m.value) for m in getattr(tpy, name)] == \
            [(m.name, m.value) for m in getattr(jpy, name)]
    assert tpy.POINT3D_DTYPE == jpy.POINT3D_DTYPE
    assert tpy.POINT3D_DTYPE.descr == jpy.POINT3D_DTYPE.descr
    for factory in ("DefaultDrivingProfile", "RobustDrivingProfile",
                    "DefaultRobustOutdoorLowInertia"):
        assert getattr(tpy.OdometryOptions, factory)() == options_from_dict(
            dataclasses.asdict(getattr(jpy.OdometryOptions, factory)()))
    assert tpy.OdometryOptions() == options_from_dict(
        dataclasses.asdict(jpy.OdometryOptions()))
    xyz = np.random.default_rng(0).normal(size=(10, 3))
    ts = np.linspace(0, 0.1, 10)
    ft, fj = tpy.LiDARFrame.from_xyz(xyz, ts), jpy.LiDARFrame.from_xyz(xyz,
                                                                       ts)
    assert ft.GetStructuredArrayRef().tobytes() == \
        fj.GetStructuredArrayRef().tobytes()
    f = tpy.LiDARFrame(3)
    assert f.GetWrappingArray() is f.points and f.points.shape == (3,)
    f.SetFrame(ft.points)
    assert f.points.tobytes() == ft.points.tobytes()
    with pytest.raises(AssertionError):
        f.SetFrame(np.zeros(3))


def test_register_frame_matches_reference():
    todo = tpy.Odometry(port_options(), device="cpu")
    jodo = jpy.Odometry(small_options())
    for i, fr in enumerate(frames()[:3]):
        if i < 2:
            ft = tpy.LiDARFrame.from_xyz(fr["xyz"], fr["timestamps"])
            fj = jpy.LiDARFrame.from_xyz(fr["xyz"], fr["timestamps"])
            st, sj = todo.RegisterFrame(ft), jodo.RegisterFrame(fj)
        else:
            st = todo.RegisterFrameRaw(fr["xyz"], fr["timestamps"])
            sj = jodo.RegisterFrameRaw(fr["xyz"], fr["timestamps"])
        assert st.success and sj.success
        assert_frames_close(st.frame, sj.frame)
        assert todo.MapSize() == jodo.MapSize()
    tt, tj = todo.Trajectory(), jodo.Trajectory()
    assert len(tt) == len(tj) == 3
    for a, b in zip(tt, tj):
        assert_frames_close(a, b)
    local_t, local_j = todo.GetLocalMap(), jodo.GetLocalMap()
    assert local_t.shape == local_j.shape and local_t.shape[1] == 6
    todo.Reset()
    assert todo.MapSize() == 0 and todo.Trajectory() == []
    todo.Reset(port_options())
    assert todo._odometry.device.type == "cpu"


@pytest.fixture
def ply_directory(tmp_path):
    frames_dir = tmp_path / "seq" / "frames"
    frames_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        write_ply_xyzt(frames_dir / f"frame_{i:05d}.ply",
                       rng.normal(size=(40, 3)), np.full(40, float(i)))
    return frames_dir


def test_dataset_helpers_match_reference(ply_directory):
    opts_t = tpy.DatasetOptions(dataset=TEnum.PLY_DIRECTORY,
                                root_path=str(ply_directory))
    opts_j = jpy.DatasetOptions(dataset=JEnum.PLY_DIRECTORY,
                                root_path=str(ply_directory))
    infos_t, infos_j = tpy.get_sequences(opts_t), jpy.get_sequences(opts_j)
    assert [dataclasses.asdict(i) for i in infos_t] == \
        [dataclasses.asdict(i) for i in infos_j]
    name = tpy.sequence_name(opts_t, 0)
    assert name == jpy.sequence_name(opts_j, 0)
    assert tpy.has_ground_truth(opts_t, name) is \
        jpy.has_ground_truth(opts_j, name) is False
    assert not tpy.has_ground_truth(opts_t, "absent")
    st = tpy.get_dataset_sequence(opts_t, name)
    sj = jpy.get_dataset_sequence(opts_j, name)
    assert (st.NumFrames(), st.WithRandomAccess(), st.HasNext()) == \
        (sj.NumFrames(), sj.WithRandomAccess(), sj.HasNext()) == (3, True,
                                                                   True)
    while st.HasNext():
        assert st.Next().points.tobytes() == sj.Next().points.tobytes()
    assert not sj.HasNext()
    assert st.Frame(2).points.tobytes() == sj.Frame(2).points.tobytes()
    assert float(st.Frame(2).points["timestamp"][0]) == 2.0
    for mod, opts in ((tpy, opts_t), (jpy, opts_j)):
        with pytest.raises(ValueError, match="no ground truth"):
            mod.load_ground_truth(opts, name)
        assert mod.load_ground_truth is mod.load_sensor_ground_truth
