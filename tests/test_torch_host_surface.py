"""The reference's remaining public names in the port, each against
ct_icp_tpu's on the same inputs: the Pose / TrajectoryFrame /
LinearContinuousTrajectory methods, DistanceBasedStrategyOptions.
compute_radius and apply_uniform_noise (numpy float64 in both packages:
bit for bit), the torch se3 matrix functions (float32 against jax.numpy),
neighborhood.classify and its constants, voxel_map.find_slots and
Odometry.get_visible_map_points. And the repair of
RegistrationSummary.corrected_points on the fused, robust and streamed
paths: set where the reference sets it, on the device, its valid rows the
reference's and its points within the cross-package pose bound (5 mm,
0.05 deg) times their range."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.config.options import DistanceBasedStrategyOptions as TDist
from ct_icp_torch.convert import map_state_from_numpy
from ct_icp_torch.core import se3 as ts3
from ct_icp_torch.core.pose import Pose as TPose
from ct_icp_torch.core.pose import TrajectoryFrame as TFrame
from ct_icp_torch.core.trajectory import LinearContinuousTrajectory as TTraj
from ct_icp_torch.datasets import synthetic as tsyn
from ct_icp_torch.mapping import voxel_map as tvm
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_torch.ops import neighborhood as tnb
from ct_icp_tpu.config.options import DistanceBasedStrategyOptions as JDist
from ct_icp_tpu.core import se3 as js3
from ct_icp_tpu.core.pose import Pose as JPose
from ct_icp_tpu.core.pose import TrajectoryFrame as JFrame
from ct_icp_tpu.core.trajectory import LinearContinuousTrajectory as JTraj
from ct_icp_tpu.datasets import synthetic as jsyn
from ct_icp_tpu.mapping import voxel_map as jvm
from ct_icp_tpu.ops import neighborhood as jnb
from tests.torch_surface_cases import (assert_frames_close,
                                       assert_points_close, frames,
                                       host_points, port_options,
                                       reference_run)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One torch thread: the plain kernels run many small ops, and the other
    test workers keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _poses(cls, n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = rng.normal(size=4)
        out.append(cls(q / np.linalg.norm(q), rng.normal(size=3) * 5,
                       0.1 * i + rng.uniform(0, 0.05), i))
    return out


def _same_pose(a, b):
    np.testing.assert_array_equal(a.quat, b.quat)
    np.testing.assert_array_equal(a.tr, b.tr)
    assert (a.timestamp, a.frame_id) == (b.timestamp, b.frame_id)


def test_pose_and_frame_methods_bit_for_bit():
    tp, jp = _poses(TPose), _poses(JPose)
    for i in range(len(tp) - 1):
        for ts in (tp[i].timestamp - 1.0, 0.5 * (tp[i].timestamp
                                                 + tp[i + 1].timestamp),
                   tp[i + 1].timestamp + 1.0):
            _same_pose(tp[i].interpolate(tp[i + 1], ts),
                       jp[i].interpolate(jp[i + 1], ts))
        tf, jf = TFrame(tp[i], tp[i + 1]), JFrame(jp[i], jp[i + 1])
        tg, jg = TFrame(tp[-1], tp[0]), JFrame(jp[-1], jp[0])
        assert tf.translation_distance(tg) == jf.translation_distance(jg)
        assert tf.rotation_distance(tg) == jf.rotation_distance(jg)
        np.testing.assert_array_equal(tf.mid_pose(), jf.mid_pose())
        _same_pose(tf.relative_begin_end(), jf.relative_begin_end())


def test_trajectory_methods_bit_for_bit():
    tt, jt = TTraj.create(_poses(TPose, 8)), JTraj.create(_poses(JPose, 8))
    rng = np.random.default_rng(1)
    pts, ts = rng.normal(size=(50, 3)) * 10, rng.uniform(-0.1, 0.9, 50)
    np.testing.assert_array_equal(tt.transform_points(pts, ts),
                                  jt.transform_points(pts, ts))
    for a, b in zip(tt.to_relative_poses(), jt.to_relative_poses()):
        _same_pose(a, b)
    tr = TTraj.from_relative_poses(tt.to_relative_poses())
    jr = JTraj.from_relative_poses(jt.to_relative_poses())
    for a, b in zip(tr.poses, jr.poses):
        _same_pose(a, b)
    ref_t, ref_j = _poses(TPose, 1, seed=5)[0], _poses(JPose, 1, seed=5)[0]
    for a, b in zip(tt.change_reference_frame(ref_t).poses,
                    jt.change_reference_frame(ref_j).poses):
        _same_pose(a, b)
    ws, wj = tt.select_window(0.15, 0.55), jt.select_window(0.15, 0.55)
    assert 0 < len(ws) == len(wj) < len(tt)
    for a, b in zip(ws.poses, wj.poses):
        _same_pose(a, b)


def test_se3_matrix_functions_match_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    mt = ts3.quat_to_matrix(tq).numpy()
    np.testing.assert_allclose(mt, np.asarray(js3.quat_to_matrix(q)),
                               atol=1e-6)
    # the quaternion of a matrix, up to its sign (w >= 0 here by the pivot)
    qt = ts3.quat_from_matrix(torch.from_numpy(mt)).numpy()
    qj = np.asarray(js3.quat_from_matrix(jnp.asarray(mt)))
    np.testing.assert_allclose(qt, qj, atol=1e-6)
    np.testing.assert_allclose(np.abs(np.sum(qt * q, axis=1)), 1.0,
                               atol=1e-6)
    st = ts3.se3_matrix(tq, tt).numpy()
    np.testing.assert_allclose(st, np.asarray(js3.se3_matrix(q, t)),
                               atol=1e-6)
    assert st.shape == (64, 4, 4) and np.all(st[:, 3] == [0, 0, 0, 1])


def test_compute_radius_and_uniform_noise_bit_for_bit():
    d = np.linspace(-5.0, 80.0, 101)
    for kw in ({}, dict(radius_min=0.3, radius_max=3.0, exponent=2.0)):
        np.testing.assert_array_equal(TDist(**kw).compute_radius(d),
                                      JDist(**kw).compute_radius(d))
    out_t = tsyn.apply_uniform_noise(_poses(TPose), np.random.default_rng(4),
                                     0.2, 3.0)
    out_j = jsyn.apply_uniform_noise(_poses(JPose), np.random.default_rng(4),
                                     0.2, 3.0)
    for a, b in zip(out_t, out_j):
        _same_pose(a, b)


def test_classify_matches_reference_and_the_solver():
    rng = np.random.default_rng(3)
    lin = rng.uniform(0, 1, 400).astype(np.float32)
    pla = rng.uniform(0, 1, 400).astype(np.float32)
    lin[:20], pla[20:40] = 0.6, 0.4           # at the thresholds
    count = rng.integers(0, 12, 400).astype(np.int32)
    assert (tnb.CLASS_NONE, tnb.CLASS_PLANAR, tnb.CLASS_LINEAR,
            tnb.CLASS_VOLUMIC) == (jnb.CLASS_NONE, jnb.CLASS_PLANAR,
                                   jnb.CLASS_LINEAR, jnb.CLASS_VOLUMIC)
    ct = tnb.classify(types.SimpleNamespace(
        linearity=torch.from_numpy(lin), planarity=torch.from_numpy(pla)),
        0.6, 0.4, torch.from_numpy(count))
    cj = jnb.classify(types.SimpleNamespace(
        linearity=jnp.asarray(lin), planarity=jnp.asarray(pla)),
        0.6, 0.4, jnp.asarray(count))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    # the solver's ROBUST classes, written inline before: the same masks
    planar = pla > 0.4
    linear = ~planar & (lin > 0.6)
    np.testing.assert_array_equal(ct.numpy() == tnb.CLASS_PLANAR, planar)
    np.testing.assert_array_equal(ct.numpy() == tnb.CLASS_LINEAR, linear)


def test_find_slots_matches_reference():
    jodo, _ = reference_run()
    jlevel = jodo.map_state.levels[0]
    tlevel = map_state_from_numpy([jlevel])[0]
    res = jodo.options.map_options.resolutions[0].resolution
    pts = np.asarray(jlevel.points).reshape(-1, 3, jlevel.points.shape[1]
                                            // 3)[:, :, 0]
    occupied = np.asarray(jlevel.count) > 0
    coords = np.trunc(pts[occupied] / res).astype(np.int32)[:500]
    coords = np.concatenate([coords, coords + 10_000]).astype(np.int32)
    st = tvm.find_slots(tlevel, torch.from_numpy(coords)).numpy()
    sj = np.asarray(jvm.find_slots(jlevel, jnp.asarray(coords)))
    np.testing.assert_array_equal(st, sj)
    assert np.all(st[:500] >= 0) and np.all(st[500:] == -1)


def _port_run(n, robust=False):
    odo = TOdometry(port_options(robust_registration=robust), device="cpu")
    out = [odo.register_frame(fr["xyz"], fr["timestamps"], frame_id=i)
           for i, fr in enumerate(frames()[:n])]
    return odo, out


@pytest.fixture(scope="module")
def fused_runs():
    return _port_run(3), reference_run(3)


def test_visible_map_points(fused_runs):
    """On the coarsest level (1.5 m voxels: the finer levels' voxels hold
    too few points for a normal), from a view point outside the room:
    the port's selection is its export filtered by the reference's rule,
    and its size the reference's within 1 % (the maps' normals agree to
    float32 summation order)."""
    (todo, _), (jodo, _) = fused_runs
    view = np.array([30.0, 0.0, 2.0])
    pn = todo.get_map_points(2)
    vis = todo.get_visible_map_points(view, 2)
    scal = np.sum(pn[:, 3:6] * (pn[:, 0:3] - view), axis=1)
    np.testing.assert_array_equal(vis, pn[scal < 0.0])
    assert 100 < len(vis) < len(pn) - 100
    jvis = jodo.get_visible_map_points(view, 2)
    assert abs(len(vis) - len(jvis)) <= 0.01 * len(jvis)


def _check_corrected(port_summaries, ref_summaries):
    for ts, js in zip(port_summaries, ref_summaries):
        world, valid = ts.corrected_points
        assert torch.is_tensor(world) and world.device.type == "cpu"
        assert world.dtype == torch.float32 and valid.dtype == torch.bool
        assert int(valid.sum()) == int(js.corrected_points[1].sum())
        assert_frames_close(ts.frame, js.frame)
        assert_points_close(host_points(ts.corrected_points),
                            host_points(js.corrected_points),
                            js.frame.end_pose.tr)


def test_fused_path_corrected_points(fused_runs):
    (_, ts), (_, js) = fused_runs
    _check_corrected(ts, js)
    # frame 0: the identity pose, the points as given
    np.testing.assert_array_equal(host_points(ts[0].corrected_points),
                                  host_points(js[0].corrected_points))


def test_robust_path_corrected_points():
    _, ts = _port_run(3, robust=True)
    _, js = reference_run(3, robust=True)
    assert [s.number_of_attempts for s in ts] == \
        [s.number_of_attempts for s in js]
    _check_corrected(ts, js)


def test_streamed_path_corrected_points(fused_runs):
    """The reference sets them on the frames it streams one at a time (a
    batch of 1, and the frames after the last full batch) and leaves them
    None on a full batch's (ct_icp_tpu/odometry/odometry.py:600-605,
    759-762, 806); held against the reference's per-frame run of the same
    frames."""
    _, js = fused_runs[1]
    for batch, kept in ((1, [True] * 3), (2, [False, False, True])):
        odo = TOdometry(port_options(), device="cpu")
        preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i)
                 for i, f in enumerate(frames()[:3])]
        ts = list(odo.stream_frames(iter(preps), batch=batch))
        assert [s.corrected_points is not None for s in ts] == kept
        assert not odo._pending_worlds
        _check_corrected([s for s in ts if s.corrected_points is not None],
                         [j for j, k in zip(js, kept) if k])
