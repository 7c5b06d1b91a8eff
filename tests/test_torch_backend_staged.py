"""The CT-BA backend on a staged profile: ct_icp_torch (CPU, plain kernel
versions) against ct_icp_tpu, frame by frame through ``register_frame``.

tests/test_torch_staged.py's ADAPTIVE options and room (6,000 points a
frame, min_number_neighbors 10) with the backend on (window 8, period 8,
2 steps of 2 inner iterations), over 12 frames: the staged path hands the
backend each frame's keypoints through its FINISHED_REGISTRATION callback.

* The keypoints handed over: bit for bit on every frame. The staged runs'
  poses part from frame 2 on (ROADMAP C.2: float32 sums in another order),
  but the ADAPTIVE keypoints are elected from the raw scan in the sensor
  frame, with their alpha-timestamps, before any pose is applied: the
  parting never reaches them;
* the first refine, run by the port from the reference's own window
  carried across (its map, trajectory, origin and keypoints): the refined
  poses within tests/test_torch_backend.py's tolerances (5 mm, 0.05 deg)
  of the reference's;
* the refinement counts are equal, and both runs succeed on every frame.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ct_icp_torch import convert
from ct_icp_torch.core.pose import Pose, TrajectoryFrame
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry
from test_torch_backend import POSE_ATOL_DEG, POSE_ATOL_M
from test_torch_staged import _staged

N = 12
WINDOW = PERIOD = 8


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def frames():
    from ct_icp_tpu.datasets import synthetic as syn
    prims = syn.box_room(half_extent=7.9, height=4.0)
    prims += syn.rectangle([-3, 2, 0], [3, 0, 0], [0, 0, 3])
    prims.append(syn.Ball(np.array([3.0, -3.0, 1.0]), 1.0))
    traj = syn.circular_trajectory(radius=6.0, height=1.5, num_poses=100,
                                   total_time=N * 0.1 + 0.3,
                                   angle_span=np.pi / 8)
    acq = syn.SyntheticSensorAcquisition(
        syn.Scene(prims), traj,
        syn.SyntheticAcquisitionOptions(num_points_per_frame=6000,
                                        frame_duration=0.1, max_range=30.0,
                                        noise_sigma=0.01), seed=3)
    return [acq.frame(i) for i in range(N)]


def _options():
    jo = _staged("adaptive")
    jo = dataclasses.replace(jo, backend=dataclasses.replace(
        jo.backend, enabled=True, window=WINDOW, period=PERIOD))
    return jo, convert.options_from_dict(dataclasses.asdict(jo))


def _record_keypoints(backend):
    """Every frame's keypoints as the callback hands them to ``backend``,
    as numpy arrays."""
    seen = {}
    inner = backend._on_finished

    def on_finished(odometry, summary, keypoints=None):
        if summary is not None and summary.keypoints is not None:
            fid = len(odometry.trajectory) - 1
            seen[fid] = tuple(np.asarray(x) for x in summary.keypoints)
        return inner(odometry, summary, keypoints)

    backend._on_finished = on_finished
    odometry = backend.odometry
    cbs = odometry.callbacks[type(odometry).FINISHED_REGISTRATION]
    cbs[cbs.index(inner)] = on_finished
    return seen


def _capture_first_window(jodo):
    """The reference's state at its first refine: levels, trajectory,
    origin and the backend's window of keypoints."""
    store = {}
    b = jodo.backend
    inner = b._refine

    def refine():
        if not store:
            store.update(
                levels=[{f: np.asarray(getattr(lv, f)) for f in lv._fields}
                        for lv in jodo.map_state.levels],
                trajectory=[f.copy() for f in jodo.trajectory],
                origin=jodo.origin.copy(),
                keypoints=[(kp[0],) + tuple(np.asarray(x) for x in kp[1:])
                           for kp in b._keypoints])
        inner()

    b._refine = refine
    return store


@pytest.fixture(scope="module")
def runs(frames):
    jo, to = _options()
    jodo, todo = JOdometry(jo), TOdometry(to, device="cpu")
    jseen, tseen = (_record_keypoints(o.backend) for o in (jodo, todo))
    window = _capture_first_window(jodo)
    jsum, tsum = [], []
    for i, f in enumerate(frames):
        jsum.append(jodo.register_frame(f["xyz"], f["timestamps"],
                                        frame_id=i))
        tsum.append(todo.register_frame(f["xyz"], f["timestamps"],
                                        frame_id=i))
    return dict(jodo=jodo, todo=todo, jseen=jseen, tseen=tseen,
                window=window, jsum=jsum, tsum=tsum,
                jtraj=jodo.get_trajectory(), ttraj=todo.get_trajectory())


def test_runs_succeed_and_refine_alike(runs):
    assert all(s.success for s in runs["jsum"])
    assert all(s.success for s in runs["tsum"])
    jb, tb = runs["jodo"].backend, runs["todo"].backend
    assert tb.refinements == jb.refinements == 1
    # frame 0 only starts the map: the callback hands keypoints from frame 1
    assert sorted(runs["tseen"]) == sorted(runs["jseen"]) == list(range(1, N))


def test_keypoints_handed_over_bit_for_bit(runs):
    for fid in range(1, N):
        jraw, jal, jvalid = runs["jseen"][fid]
        traw, tal, tvalid = runs["tseen"][fid]
        np.testing.assert_array_equal(tvalid, jvalid)
        assert int(tvalid.sum()) > 100
        np.testing.assert_array_equal(traw[tvalid], jraw[jvalid])
        np.testing.assert_array_equal(tal[tvalid], jal[jvalid])


def _port_pose(p):
    return Pose(np.array(p.quat), np.array(p.tr), p.timestamp, p.frame_id)


def test_first_refine_from_the_reference_window(runs):
    w = runs["window"]
    _, to = _options()
    odo = TOdometry(to, device="cpu")
    odo.map_state = convert.map_state_from_numpy(w["levels"])
    odo.trajectory = [TrajectoryFrame(_port_pose(f.begin_pose),
                                      _port_pose(f.end_pose))
                      for f in w["trajectory"]]
    odo.registered_frames = len(odo.trajectory)
    odo.origin = w["origin"]
    b = odo.backend
    b._keypoints = [kp for kp in w["keypoints"]]
    fids = [kp[0] for kp in b._keypoints if kp[0] >= b.keep_first]
    assert len(fids) >= 6
    b._refine()
    got = odo.get_trajectory()
    want = runs["jtraj"]
    moved = 0.0
    for f in fids:
        for key in ("begin_pose", "end_pose"):
            pa, pb = getattr(got[f], key), getattr(want[f], key)
            assert np.abs(pa.tr - pb.tr).max() < POSE_ATOL_M
            assert pa.angular_distance(pb) < POSE_ATOL_DEG
            moved = max(moved, np.abs(
                pa.tr - getattr(w["trajectory"][f], key).tr).max())
    assert moved > 1e-6     # the refine moved the window's poses
