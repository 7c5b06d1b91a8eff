"""Shared inputs of the runner-slice parity tests (test_torch_runner.py,
test_torch_checkpoint.py, test_torch_concurrent.py): tests/test_odometry.py's
small options and synthetic room, in both packages. Not collected by
pytest."""

import dataclasses

import numpy as np

from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.datasets import synthetic as tsyn
from tests.test_odometry import make_acquisition, small_options


def options_pair(**kw):
    """(JAX options, the port's same options)."""
    jo = small_options(**kw)
    return jo, options_from_dict(dataclasses.asdict(jo))


def port_acquisition(seed=0, num_frames=25):
    """tests/test_odometry.py's make_acquisition in the port's synthetic
    module (the same frames)."""
    prims = tsyn.box_room(half_extent=12.0, height=5.0)
    prims.append(tsyn.Sphere(np.array([0.0, 0.0, 2.0]), 2.0))
    prims.append(tsyn.Ball(np.array([5.0, -4.0, 1.0]), 1.0))
    prims += tsyn.rectangle([-4, 2, 0], [3, 0, 0], [0, 0, 3])
    traj = tsyn.circular_trajectory(radius=6.0, height=1.5, num_poses=200,
                                    total_time=num_frames * 0.1 + 0.2,
                                    angle_span=np.pi / 2)
    opts = tsyn.SyntheticAcquisitionOptions(
        num_points_per_frame=6000, frame_duration=0.1, max_range=60.0)
    return tsyn.SyntheticSensorAcquisition(tsyn.Scene(prims), traj, opts,
                                           seed=seed)


def acquisitions(seed):
    """(the port's, the reference's) acquisition of the same room."""
    return port_acquisition(seed), make_acquisition(seed=seed)


def frames(seed, n):
    acq = make_acquisition(seed=seed)
    return [acq.frame(i) for i in range(n)]


def end_gap(a, b):
    """(metres, degrees): the largest end-pose gap of two trajectories."""
    assert len(a) == len(b)
    return (max(x.end_pose.location_distance(y.end_pose)
                for x, y in zip(a, b)),
            max(x.end_pose.angular_distance(y.end_pose)
                for x, y in zip(a, b)))
