"""The static room of the reference's odometry and backend-replay tests.

An own copy of ``tests/test_odometry.py::make_acquisition`` (:42-54): a
24 m x 24 m x 5 m box room with a sphere, a ball and an interior wall,
scanned along a quarter circle of radius 6 m at 10 Hz; and of the replay
gate of ``tests/test_ct_ba.py::
test_backend_on_beats_backend_off_under_degraded_odometry`` (:182-224): 15
frames of seed 47 with 5 mm noise, a front end degraded to 2 ICP
iterations of 1 LM step, the backend on (window 6, period 3, 2 steps,
replay) against off; on must beat off by 20 % in mean relative APE, with at
least 2 refinements. Built on ``datasets/synthetic.py``.
"""

import dataclasses

import numpy as np

from ct_icp_torch.config.options import (BackendOptions, CTICPOptions,
                                         OdometryOptions)
from ct_icp_torch.datasets import synthetic as syn

# the replay gate (tests/test_ct_ba.py:193-224)
REPLAY_SEED = 47
REPLAY_NOISE = 0.005
REPLAY_FRAMES = 15
REPLAY_WINDOW = 6
REPLAY_PERIOD = 3
REPLAY_STEPS = 2
REPLAY_APE_FACTOR = 0.8       # APE on < factor x APE off
REPLAY_MIN_REFINEMENTS = 2
POINTS_PER_FRAME = 6000


def make_acquisition(seed: int = 0, num_frames: int = 25,
                     noise: float = 0.0,
                     points_per_frame: int = POINTS_PER_FRAME
                     ) -> syn.SyntheticSensorAcquisition:
    """The room scanned along a quarter circle (reference
    tests/test_odometry.py:42-54); ``points_per_frame`` 6,000 there."""
    prims = syn.box_room(half_extent=12.0, height=5.0)
    prims.append(syn.Sphere(np.array([0.0, 0.0, 2.0]), 2.0))
    prims.append(syn.Ball(np.array([5.0, -4.0, 1.0]), 1.0))
    prims += syn.rectangle([-4, 2, 0], [3, 0, 0], [0, 0, 3])  # interior wall
    scene = syn.Scene(prims)
    traj = syn.circular_trajectory(radius=6.0, height=1.5, num_poses=200,
                                   total_time=num_frames * 0.1 + 0.2,
                                   angle_span=np.pi / 2)
    opts = syn.SyntheticAcquisitionOptions(
        num_points_per_frame=points_per_frame, frame_duration=0.1,
        max_range=60.0, noise_sigma=noise)
    return syn.SyntheticSensorAcquisition(scene, traj, opts, seed=seed)


def reference_test_profile(base: OdometryOptions = OdometryOptions()
                           ) -> OdometryOptions:
    """The reference test's front end (tests/test_odometry.py:27-39
    ``small_options``: 5 startup frames, a 100 m prune distance, 6 ICP
    iterations of 2 LM steps, 10 neighbours, 50 residuals) at the
    capacities of ``base`` (the default profile's: the three-level map at
    2^20 / 2^19 / 2^17 slots, 2^17 scan points, 4,096 keypoints)."""
    return dataclasses.replace(
        base, init_num_frames=5, max_distance=100.0,
        ct_icp_options=CTICPOptions(num_iters_icp=6, ls_max_num_iters=2,
                                    min_number_neighbors=10,
                                    min_num_residuals=50))


def replay_options(enabled: bool, base: OdometryOptions = None,
                   window: int = REPLAY_WINDOW, period: int = REPLAY_PERIOD
                   ) -> OdometryOptions:
    """The replay gate's options: ``base`` (``reference_test_profile()``
    when None) degraded to 2 ICP iterations of 1 LM step, the backend
    ``enabled`` or not, with replay."""
    o = reference_test_profile() if base is None else base
    return dataclasses.replace(
        o, ct_icp_options=dataclasses.replace(
            o.ct_icp_options, num_iters_icp=2, ls_max_num_iters=1),
        backend=BackendOptions(enabled=enabled, window=window, period=period,
                               num_steps=REPLAY_STEPS, replay=True))


def relative_ape(trajectory, gt_ends) -> float:
    """Mean over frames 1.. of the distance between the estimated and the
    true end position, each taken relative to frame 0's (the reference
    test's measure)."""
    first_gt, first_est = gt_ends[0], trajectory[0].end_pose
    errs = [(first_gt.inverse() * gt).location_distance(
                first_est.inverse() * est.end_pose)
            for est, gt in zip(trajectory[1:], gt_ends[1:])]
    return float(np.mean(errs))
