"""Short streamed runs of the three options this slice ports, ct_icp_torch
(CPU, plain kernel versions) against ct_icp_tpu on the same frames:

* ``ball_neighborhood=False``: the exact k-NN search each ICP iteration;
* ``distance_strategy``: a radius a keypoint, the normal filter, and
  inserts that keep the voxel normals;
* ``host_subsample=False``: the raw scan packed as it is and sub-sampled
  on the device (two grid elections a frame: the scan, the keypoints).

The driving profile on one small level (0.8 m voxels, 30 points, 2^14
slots, 1,024 keypoints) over 8 frames of tests/test_torch_odometry.py's
room, moved off the voxel edges, streamed at batch 4. The prepared scans
are identical; success and insertion flags and the residuals of every
frame are equal, and the end poses within 5 mm and 0.05 deg (float32 sums
in another order move the solver's iterates slightly). The map sizes
after each batch agree within 0.05 %: the poses part by up to ~1 mm,
and a frame's points that lie within that gap of a voxel edge or of
another point's 0.1 m minimum distance land otherwise (about 0.3 % of a
frame's 20,000 points a millimetre; 0 to 4 points apart here, and equal
where the poses stay within a micrometre, as the distance strategy's do).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.kernels import grid_sample as k4
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry
from ct_icp_tpu.datasets import synthetic as syn

N_FRAMES = 8
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _frames():
    """tests/test_torch_odometry.py's room and drive, the room 0.1 m
    narrower: no wall lies on a 0.8 m voxel edge of the first frame's
    coordinates (on an edge, a sub-micrometre pose difference moves the
    points of a whole wall between two voxels, and the map sizes part)."""
    prims = syn.box_room(half_extent=7.9, height=4.0)
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


def _options(variant):
    d = jopt.default_driving_profile()
    d = dataclasses.replace(
        d, map_options=dataclasses.replace(
            d.map_options, resolutions=(jopt.ResolutionParam(0.8, 0.1, 30,
                                                             14),)),
        max_scan_points=32768, max_subsampled_points=32768,
        max_keypoints=1024, max_dirty_voxels=4096)
    if variant == "knn":
        return dataclasses.replace(d, ct_icp_options=dataclasses.replace(
            d.ct_icp_options, ball_neighborhood=False))
    if variant == "distance":
        return dataclasses.replace(
            d, distance_strategy=jopt.DistanceBasedStrategyOptions())
    return dataclasses.replace(d, host_subsample=False)


def _stream(odo, frames, **prep_kw):
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i,
                               **prep_kw) for i, f in enumerate(frames)]
    sizes, out = [], []
    for s in odo.stream_frames(iter(preps), batch=BATCH):
        out.append(s)
        if len(out) % BATCH == 0:
            sizes.append(odo.map_size())
    return preps, out, sizes


@pytest.mark.parametrize("variant", ["knn", "distance", "devsub"])
def test_streamed_search_matches_reference(variant, monkeypatch):
    elections = []
    plain = k4.grid_sample_plain

    def spy(points, *args, **kw):
        elections.append(points.shape[0])
        return plain(points, *args, **kw)

    monkeypatch.setattr(k4, "grid_sample_plain", spy)
    jo = _options(variant)
    frames = _frames()
    jodo = JOdometry(jo)
    todo = TOdometry(options_from_dict(dataclasses.asdict(jo)), device="cpu")
    jpreps, jsum, jsizes = _stream(jodo, frames, upload=False)
    tpreps, tsum, tsizes = _stream(todo, frames)
    for jp, tp in zip(jpreps, tpreps):
        np.testing.assert_array_equal(tp["scan_host"], jp["scan_host"])
        assert tp["kp_n"] == jp["kp_n"]
    assert [s.success for s in tsum] == [s.success for s in jsum]
    assert all(s.success for s in tsum)
    assert [s.points_added for s in tsum] == [s.points_added for s in jsum]
    assert ([s.number_of_residuals for s in tsum]
            == [s.number_of_residuals for s in jsum])
    assert tsizes[0] > 10000
    for a, b in zip(tsizes, jsizes):
        assert abs(a - b) <= 5e-4 * b
    for a, b in zip(todo.get_trajectory(), jodo.get_trajectory()):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3
        assert a.end_pose.angular_distance(b.end_pose) < 0.05
    traj = todo.get_trajectory()
    assert traj[-1].end_pose.location_distance(traj[0].end_pose) > 0.3
    if variant == "devsub":
        # the raw scans went up unsorted at the scan's rung, and each frame
        # elected twice on the device: its sub-sample, then its keypoints
        assert all(p["kp_n"] == 0 and p["n"] == f["xyz"].shape[0]
                   for p, f in zip(tpreps, frames))
        assert elections[0::2] == [32768] * N_FRAMES
        assert len(elections) == 2 * N_FRAMES
        assert ([s.logged_values["odometry_num_subsampled"] for s in tsum]
                == [s.logged_values["odometry_num_subsampled"]
                    for s in jsum])
    else:
        assert not elections
    if variant == "distance":
        # the inserts kept the normals: voxels flagged, as the reference's
        jl, tl = jodo.map_state.levels[0], todo.map_state[0]
        assert int((tl.nflags == 2).sum()) == int(
            (np.asarray(jl.nflags) == 2).sum()) > 100

