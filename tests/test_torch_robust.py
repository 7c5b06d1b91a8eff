"""The robust regimen per frame: ct_icp_torch (CPU, plain kernel versions)
against ct_icp_tpu on the same frames, and the robust gates' scenes.

A single 0.5 m map level (the robust profile's layout) at the size of
tests/test_odometry.py's ``small_options``, with
``robust_registration=True`` and three attempts, on a room scene whose
rotation rate needs robust level 1 (the escalated attempts sample keypoints
at 1.5 m / 1.5 = 1.0 m, off the host prefix, so the device grid election
runs). Attempts, robust levels, success and insertion decisions are equal;
end poses agree within 5 mm (float32 sums in another order move the
solver's iterates slightly).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import bench
from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.datasets import corridor
from ct_icp_torch.kernels import grid_sample as k4
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.datasets import synthetic as syn
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry

ROBUST_MAP = jopt.MultiResolutionVoxelMapOptions(
    resolutions=(jopt.ResolutionParam(0.5, 0.1, 25, 15),), default_radius=0.8)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """The port's plain kernels run many small ops: one torch thread does
    them at about the same speed, and leaves the cores to the other test
    workers (spinning intra-op threads slowed a parallel run several
    times over)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def robust_options(**kw) -> jopt.OdometryOptions:
    kw = {"init_num_frames": 5, "robust_num_attempts": 3, **kw}
    return jopt.OdometryOptions(
        map_options=ROBUST_MAP, max_scan_points=8192,
        max_subsampled_points=8192, max_keypoints=2048,
        max_dirty_voxels=4096, max_distance=100.0,
        robust_registration=True,
        ct_icp_options=jopt.CTICPOptions(
            num_iters_icp=6, ls_max_num_iters=2, min_number_neighbors=10,
            min_num_residuals=50, threshold_orientation_norm=0.01),
        **kw)


def room_prims(off_edges=False):
    """tests/test_odometry.py's room. With ``off_edges`` it is 0.2 m
    narrower and 0.1 m lower and its panel 0.15 m further out, so that with
    the drive 5 cm lower no plane lies on a 0.5 m voxel edge of the first
    frame's coordinates: on an edge, a sub-micrometre pose difference (float32
    sums in another order) moves the points of a whole plane between two
    voxels."""
    half, height, panel_y = (11.8, 4.9, 2.15) if off_edges else (12.0, 5.0,
                                                                 2.0)
    prims = syn.box_room(half_extent=half, height=height)
    prims.append(syn.Sphere(np.array([0.0, 0.0, 2.0]), 2.0))
    prims.append(syn.Ball(np.array([5.0, -4.0, 1.0]), 1.0))
    prims += syn.rectangle([-4, panel_y, 0], [3, 0, 0], [0, 0, 3])
    return prims


def room_frames(n, seed=11, angle_span=np.pi / 2, off_edges=False):
    """tests/test_odometry.py's room and circular drive (its rotation,
    3.3 deg a frame, needs robust level 1; a twelfth of it does not)."""
    traj = syn.circular_trajectory(radius=6.0,
                                   height=1.45 if off_edges else 1.5,
                                   num_poses=200,
                                   total_time=25 * 0.1 + 0.2,
                                   angle_span=angle_span)
    acq = syn.SyntheticSensorAcquisition(
        syn.Scene(room_prims(off_edges)), traj,
        syn.SyntheticAcquisitionOptions(num_points_per_frame=6000,
                                        frame_duration=0.1, max_range=60.0),
        seed=seed)
    return [acq.frame(i) for i in range(n)]


def both(jo):
    return JOdometry(jo), TOdometry(options_from_dict(dataclasses.asdict(jo)),
                                    device="cpu")


def outcome(s):
    return (s.number_of_attempts, s.robust_level, s.success, s.points_added)


@pytest.fixture
def election_calls(monkeypatch):
    """Counts the device keypoint elections the port runs (K4's plain
    version on the CPU)."""
    calls = []
    plain = k4.grid_sample_plain

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return plain(*args, **kw)

    monkeypatch.setattr(k4, "grid_sample_plain", spy)
    return calls


def test_robust_register_frame_matches_reference(election_calls):
    frames = room_frames(7)
    jodo, todo = both(robust_options())
    js = [jodo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
          for i, f in enumerate(frames)]
    ts = [todo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
          for i, f in enumerate(frames)]
    assert [outcome(s) for s in ts] == [outcome(s) for s in js]
    assert all(s.success for s in ts)
    # the run escalated, and the escalated attempts ran the election
    assert max(s.number_of_attempts for s in ts) > 1
    assert max(s.robust_level for s in ts) >= 1 and election_calls
    for a, b in zip(todo.get_trajectory(), jodo.get_trajectory()):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3
        assert a.end_pose.angular_distance(b.end_pose) < 0.05
    assert (todo.next_robust_level, todo.robust_num_consecutive_failures) \
        == (jodo.next_robust_level, jodo.robust_num_consecutive_failures)
    assert todo.map_size() == jodo.map_size() > 1000
    traj = todo.get_trajectory()
    assert traj[-1].end_pose.location_distance(traj[0].end_pose) > 0.5


def test_robust_exhaustion_matches_reference(election_calls):
    """An impossible distance threshold: every frame after the first burns
    all its attempts, climbing the ladder (each rung shrinks the sample
    voxel: the election runs); the last attempt is accepted and the
    deferred map update inserts per the host's decision."""
    frames = room_frames(4)
    # frames 2 and 3 sample at 1.5 m; their escalated attempts at 1.0 m
    jodo, todo = both(robust_options(distance_error_threshold=1e-4,
                                     init_num_frames=2))
    for i, f in enumerate(frames):
        a = jodo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
        b = todo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
        assert outcome(b) == outcome(a)
        assert b.logged_values["map_inserted_points"] == \
            a.logged_values["map_inserted_points"]
    assert b.number_of_attempts == 3 and b.robust_level >= 2
    assert todo.robust_num_consecutive_failures == \
        jodo.robust_num_consecutive_failures == 3
    assert todo.next_robust_level == jodo.next_robust_level
    assert todo.map_size() == jodo.map_size()
    assert len(election_calls) >= 4
    for a, b in zip(todo.get_trajectory(), jodo.get_trajectory()):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3


@pytest.mark.parametrize("scene", ["robust", "escalation"])
def test_robust_corridor_frames_match_bench(scene):
    """The port's copies of bench.py's robust and escalation drives render
    the same frames from the same seed (bit-identical points, timestamps
    and GT poses); the gate constants are bench.py's."""
    seed = corridor.APE_SEEDS[0]
    if scene == "robust":
        jt = bench.straight_trajectory(400, 80 * 0.1 + 0.5, speed=8.0)
        tt = corridor.robust_corridor_trajectory(80)
    else:
        b0, b1 = bench.ESC_BURST
        s0, s1 = bench.ESC_SURGE
        jt = bench._jolt_trajectory(
            400, 48 * 0.1 + 0.5, burst_t0=b0 * 0.1, burst_t1=b1 * 0.1,
            amp_deg=bench.ESC_YAW_AMP_DEG, surge_t0=s0 * 0.1,
            surge_t1=s1 * 0.1, surge_speed=bench.ESC_SURGE_SPEED)
        tt = corridor.escalation_trajectory(48)
    # every GT pose, the jolt's and the surge's included
    assert len(tt.poses) == len(jt.poses) == 400
    for p, q in zip(tt.poses, jt.poses):
        np.testing.assert_array_equal(p.tr, q.tr)
        np.testing.assert_array_equal(p.quat, q.quat)
        assert p.timestamp == q.timestamp
    jf = bench.render_corridor(bench.build_scene(), jt, 1, seed)
    tf = corridor.render_corridor(corridor.build_scene(), tt, 1, seed)
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b["xyz"], a["xyz"])
        np.testing.assert_array_equal(b["timestamps"], a["timestamps"])
        for key in ("begin_pose", "end_pose"):
            np.testing.assert_array_equal(b[key].tr, a[key].tr)
    names = ["ROBUST_APE_BOUND_M", "ROBUST_BASELINE_SEC_PER_FRAME",
             "ESC_BURST", "ESC_YAW_AMP_DEG", "ESC_SURGE", "ESC_SURGE_SPEED",
             "ESC_POST_APE_BOUND_M", "ESC_MIN_BURST_ATTEMPTS",
             "ESC_MIN_BURST_LEVEL", "ESC_MIN_GAP_LEVEL",
             "ESC_MIN_EXHAUSTED_FRAMES"]
    assert {n: getattr(corridor, n) for n in names} == \
        {n: getattr(bench, n) for n in names}
    est = types.SimpleNamespace(get_trajectory=lambda: [
        types.SimpleNamespace(end_pose=f["end_pose"]) for f in jf])
    np.testing.assert_array_equal(corridor.seq_ape(est, tf),
                                  bench.seq_ape(est, jf))


@pytest.mark.parametrize("path", ["backend", "backend_replay",
                                  "profile_registration",
                                  "constant_velocity", "frame_ring",
                                  "rebase"])
def test_paths_out_of_the_port_raise_not_implemented(path):
    """Every path here is ported now and none raises
    NotImplementedError: profile_registration and the CONSTANT_VELOCITY
    motion compensation build on a robust profile (the SIMPLE
    parametrization without distortion for the latter;
    tests/test_torch_constant_velocity.py and test_torch_profiled.py run
    them), the CT-BA backend on a robust profile ("backend"), its replay
    and the frame ring on any profile (the ring grows to the backend's
    window; a replay of frames the ring does not hold inserts nothing), and
    the rebase: a frame past the rebase distance moves the origin to its
    end position and the map with it."""
    opts = options_from_dict(dataclasses.asdict(robust_options()))
    if path == "backend":
        opts = dataclasses.replace(opts, backend=dataclasses.replace(
            opts.backend, enabled=True))
    elif path == "backend_replay":
        opts = dataclasses.replace(
            opts, robust_registration=False,
            map_options=dataclasses.replace(opts.map_options,
                                            max_frames_to_keep=3),
            backend=dataclasses.replace(opts.backend, enabled=True,
                                        replay=True))
    elif path == "profile_registration":
        opts = dataclasses.replace(opts, profile_registration=True)
    elif path == "constant_velocity":
        opts = dataclasses.replace(
            opts, motion_compensation=type(opts.motion_compensation)(
                "CONSTANT_VELOCITY"))
    if path in ("profile_registration", "constant_velocity"):
        odo = TOdometry(opts, device="cpu")
        icp = odo.options.ct_icp_options
        if path == "constant_velocity":
            assert icp.parametrization.name == "SIMPLE"
            assert not icp.point_to_plane_with_distortion
        else:
            assert odo.options.profile_registration
        return
    odo = TOdometry(opts, device="cpu")
    if path in ("backend", "backend_replay"):
        assert odo.backend is not None
        assert odo.backend.replay == (path == "backend_replay")
        assert odo.frame_ring.max_frames == (
            opts.backend.window if path == "backend_replay"
            else opts.map_options.max_frames_to_keep)
        return
    if path == "frame_ring":
        assert odo.frame_ring.enabled and len(odo.frame_ring) == 0
        assert odo.replay_refined_frames(odo.get_trajectory()) == 0
        return
    f0, f1 = room_frames(2)
    odo.register_frame(f0["xyz"], f0["timestamps"])  # the origin's frame
    level = odo.map_state[0]
    occupied = int(((level.keys != 0) & (level.keys != 1)).sum())
    odo.rebase_distance = 1e-6     # frame 1 leaves the map frame
    summary = odo.register_frame(f1["xyz"], f1["timestamps"])
    assert summary.success and odo.rebases == 1
    end = odo.trajectory[-1].end_pose.tr
    assert np.array_equal(odo.origin, end) and np.linalg.norm(end) > 0.05
    # the map was rebuilt in the new frame, not lost: its rows keep their
    # points (a few merge where the shift puts two first points in one
    # voxel), and none is a tombstone
    level = odo.map_state[0]
    rows = int(((level.keys != 0) & (level.keys != 1)).sum())
    assert 0.5 * occupied < rows and int((level.keys == 1).sum()) == 0
    assert odo.map_size() == int(level.count.sum()) > 1000
