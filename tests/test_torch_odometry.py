"""The streamed driving slice end to end: ct_icp_torch (CPU, plain kernel
versions) against ct_icp_tpu on the same frames.

A driving-like single-level map (0.8 m voxels, 30 points each, 2^14 slots,
radius 0.75, the driving profile's solver settings) and 8 synthetic frames
streamed with batch=4 by both packages: the prepared wire scans are
identical, the map after frame 0 is bit-identical, success flags are equal
and per-frame end poses agree within 5 mm and 0.05 deg (float32 sums in
another order move the solver's iterates slightly).
"""

import dataclasses
import types

import numpy as np

import bench
from ct_icp_torch.config import options as topt
from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.datasets import corridor
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.datasets import synthetic as syn
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry

N_FRAMES = 8


def _jax_options():
    d = jopt.default_driving_profile()
    return dataclasses.replace(
        d, map_options=dataclasses.replace(
            d.map_options, resolutions=(jopt.ResolutionParam(0.8, 0.1, 30,
                                                             14),)),
        max_scan_points=32768, max_subsampled_points=32768,
        max_keypoints=1024, max_dirty_voxels=4096)


def _frames():
    prims = syn.box_room(half_extent=8.0, height=4.0)
    prims += syn.rectangle([-3, 2, 0], [3, 0, 0], [0, 0, 3])
    prims.append(syn.Ball(np.array([3.0, -3.0, 1.0]), 1.0))
    traj = syn.circular_trajectory(radius=6.0, height=1.5, num_poses=100,
                                   total_time=N_FRAMES * 0.1 + 0.3,
                                   angle_span=np.pi / 12)
    acq = syn.SyntheticSensorAcquisition(
        syn.Scene(prims), traj,
        syn.SyntheticAcquisitionOptions(num_points_per_frame=20000,
                                        frame_duration=0.1, max_range=30.0,
                                        noise_sigma=0.01), seed=3)
    return [acq.frame(i) for i in range(N_FRAMES)]


def _run_jax(opts, frames):
    odo = JOdometry(opts)
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i,
                               upload=False) for i, f in enumerate(frames)]
    return odo, preps, list(odo.stream_frames(iter(preps), batch=4))


def _run_torch(opts, frames):
    odo = TOdometry(opts, device="cpu")
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
             for i, f in enumerate(frames)]
    return odo, preps, list(odo.stream_frames(iter(preps), batch=4))


def test_options_carry_across():
    jo = _jax_options()
    to = options_from_dict(dataclasses.asdict(jo))
    assert isinstance(to, topt.OdometryOptions)
    assert dataclasses.asdict(to) == dataclasses.asdict(
        options_from_dict(dataclasses.asdict(jo)))
    assert to.ct_icp_options.loss_function == topt.LeastSquares.CAUCHY
    assert to.map_options.resolutions[0] == topt.ResolutionParam(0.8, 0.1, 30,
                                                                 14)
    assert to == dataclasses.replace(
        topt.default_driving_profile(),
        map_options=to.map_options, max_scan_points=32768,
        max_subsampled_points=32768, max_keypoints=1024,
        max_dirty_voxels=4096)


def test_streamed_slice_matches_reference():
    jo = _jax_options()
    to = options_from_dict(dataclasses.asdict(jo))
    frames = _frames()

    # frame 0 alone: the map it leaves must be bit-identical
    j0, _, _ = _run_jax(jo, frames[:1])
    t0, _, _ = _run_torch(to, frames[:1])
    jl, tl = j0.map_state.levels[0], t0.map_state[0]
    np.testing.assert_array_equal(tl.keys.numpy(),
                                  np.asarray(jl.keys).view(np.int32))
    np.testing.assert_array_equal(tl.count.numpy(), np.asarray(jl.count))
    np.testing.assert_array_equal(tl.points.numpy(), np.asarray(jl.points))
    assert t0.map_size() == j0.map_size() > 1000

    jodo, jpreps, jsum = _run_jax(jo, frames)
    todo, tpreps, tsum = _run_torch(to, frames)
    for jp, tp in zip(jpreps, tpreps):
        np.testing.assert_array_equal(tp["scan_host"], jp["scan_host"])
        assert tp["kp_n"] == jp["kp_n"]
    assert [s.success for s in tsum] == [s.success for s in jsum]
    assert all(s.success for s in tsum)
    assert [s.points_added for s in tsum] == [s.points_added for s in jsum]
    for a, b in zip(todo.get_trajectory(), jodo.get_trajectory()):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3
        assert a.end_pose.angular_distance(b.end_pose) < 0.05
    # the frames moved: the comparison is not of identities
    traj = todo.get_trajectory()
    assert traj[-1].end_pose.location_distance(traj[0].end_pose) > 0.5


def test_corridor_frames_match_bench():
    """The port's copy of bench.py's driving corridor renders the same
    frames from the same seed (bit-identical points, timestamps and GT
    poses) and scores them the same way."""
    traj_args = (400, 80 * 0.1 + 0.5)
    jf = bench.render_corridor(bench.build_scene(),
                               bench.straight_trajectory(*traj_args), 2,
                               corridor.APE_SEEDS[0])
    tf = corridor.render_corridor(corridor.build_scene(),
                                  corridor.straight_trajectory(*traj_args), 2,
                                  corridor.APE_SEEDS[0])
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b["xyz"], a["xyz"])
        np.testing.assert_array_equal(b["timestamps"], a["timestamps"])
        for key in ("begin_pose", "end_pose"):
            np.testing.assert_array_equal(b[key].quat, a[key].quat)
            np.testing.assert_array_equal(b[key].tr, a[key].tr)
    assert b["xyz"].shape[0] > 40000
    assert (corridor.APE_BOUND_M, corridor.APE_SEEDS) == (bench.APE_BOUND_M,
                                                          bench.APE_SEEDS)

    # an estimate that is the ground truth in the world frame: frame 0's
    # pose is not the identity, so the errors are not zero
    est = types.SimpleNamespace(get_trajectory=lambda: [
        types.SimpleNamespace(end_pose=f["end_pose"]) for f in jf])
    np.testing.assert_array_equal(corridor.seq_ape(est, tf),
                                  bench.seq_ape(est, jf))
