"""Shared runs of the host-surface parity tests (test_torch_online.py,
test_torch_compat.py, test_torch_host_surface.py): tests/test_odometry.py's
small options and room, registered frame by frame by ct_icp_tpu once per
test process (its frame step compiles once, ~30 s on the CPU, and every
file here runs that same program), and the checks they share. Not
collected by pytest."""

import dataclasses
import functools

import numpy as np
import torch

from ct_icp_torch.convert import options_from_dict
from tests.test_odometry import make_acquisition, small_options

SEED = 29                      # tests/test_online_viz.py's room
ACROSS = (5e-3, 0.05)          # tests/test_torch_odometry.py:108-110


@functools.lru_cache(maxsize=None)
def frames(n=9):
    acq = make_acquisition(seed=SEED)
    return tuple(acq.frame(i) for i in range(n))


def port_options(**kw):
    return options_from_dict(dataclasses.asdict(small_options(**kw)))


@functools.lru_cache(maxsize=None)
def reference_run(n=3, robust=False):
    """ct_icp_tpu's Odometry over the first ``n`` frames, frame by frame:
    (the odometry, the summaries with their corrected points as numpy
    (world, valid))."""
    from ct_icp_tpu.odometry.odometry import Odometry
    odo = Odometry(small_options(robust_registration=robust))
    out = []
    for i, fr in enumerate(frames()[:n]):
        s = odo.register_frame(fr["xyz"], fr["timestamps"], frame_id=i)
        world, valid = s.corrected_points
        s.corrected_points = (np.asarray(world), np.asarray(valid))
        out.append(s)
    return odo, tuple(out)


def host_points(corrected):
    """The valid rows of a (world, valid) pair of tensors or arrays, as
    float64 numpy."""
    world, valid = corrected
    if torch.is_tensor(world):
        world, valid = world.cpu().numpy(), valid.cpu().numpy()
    return np.asarray(world, np.float64)[np.asarray(valid, bool)]


def assert_points_close(port, ref, centre):
    """Row by row within the cross-package pose bound times the range: 5 mm
    plus 0.05 deg times each point's distance from ``centre``."""
    assert port.shape == ref.shape and port.shape[0] > 0
    gap = np.linalg.norm(port - ref, axis=1)
    tol = ACROSS[0] + np.deg2rad(ACROSS[1]) * np.linalg.norm(
        ref - centre, axis=1)
    assert np.all(gap <= tol), float(np.max(gap - tol))


def assert_frames_close(a, b):
    """Two TrajectoryFrames' end poses within the cross-package bound."""
    assert a.end_pose.location_distance(b.end_pose) < ACROSS[0]
    assert a.end_pose.angular_distance(b.end_pose) < ACROSS[1]
    assert a.begin_pose.location_distance(b.begin_pose) < ACROSS[0]
