"""The staged per-frame path: ct_icp_torch (CPU, plain kernel versions)
against ct_icp_tpu, frame by frame through ``register_frame``.

tests/test_torch_odometry.py's small driving map (one 0.8 m level, 2^14
slots) and room, with ``init_num_frames=3``, over 8 frames for each staged
option: ADAPTIVE keypoints (K13's plain version), NONE (the sub-frame's
first rows), the random keypoint cap on GRID keypoints (the port's score
draw replaced by JAX's ``jax.random.uniform`` for the same seed integer,
which both packages take from their numpy generators at the same point),
ADAPTIVE on the robust regimen, and the regimen escalating every frame.

Equal: frame 0's map (bit for bit), the keypoint counts, success flags,
attempts and robust levels, and insertion decisions. End poses within 5 mm
and 0.05 deg (float32 sums in another order move the solver's iterates), as
the streamed slice's test allows. Map sizes within 0.2 % a frame: the
staged path inserts unquantized float32 points, and where the two poses
differ (by 0.1 um to 1.5 mm on these frames; frame 1, whose begin pose the
all-ones alphas leave unobserved, by up to 90 um on denser frames) a point
within that distance of a voxel face or of another point's 0.1 m
min-distance sphere lands on the other side.
Also: ``stream_frames`` refuses a staged profile; CONSTANT_VELOCITY and
``profile_registration`` build (tests/test_torch_constant_velocity.py and
test_torch_profiled.py hold them to the reference).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry

from ct_icp_tpu.datasets import synthetic as syn
from test_torch_odometry import N_FRAMES, _jax_options


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One torch thread: the plain kernels run many small ops, and the other
    test workers keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def frames():
    """tests/test_torch_odometry.py's room 0.1 m narrower (no wall on a
    0.8 m voxel edge of the first frame's coordinates) and drive, at the
    robust slice's 6,000 points a frame."""
    prims = syn.box_room(half_extent=7.9, height=4.0)
    prims += syn.rectangle([-3, 2, 0], [3, 0, 0], [0, 0, 3])
    prims.append(syn.Ball(np.array([3.0, -3.0, 1.0]), 1.0))
    traj = syn.circular_trajectory(radius=6.0, height=1.5, num_poses=100,
                                   total_time=N_FRAMES * 0.1 + 0.3,
                                   angle_span=np.pi / 12)
    acq = syn.SyntheticSensorAcquisition(
        syn.Scene(prims), traj,
        syn.SyntheticAcquisitionOptions(num_points_per_frame=6000,
                                        frame_duration=0.1, max_range=30.0,
                                        noise_sigma=0.01), seed=3)
    return [acq.frame(i) for i in range(N_FRAMES)]


def _staged(variant):
    """The variant's options. ``min_number_neighbors`` is 10: the staged
    path inserts at most 4 points a voxel a frame (the fused step's
    young-map budget does not apply there), so on these 20,000-point frames
    the driving profile's 20 neighbours are not met after frame 0, for the
    reference either."""
    o = _jax_options()
    o = dataclasses.replace(o, init_num_frames=3,
                            ct_icp_options=dataclasses.replace(
                                o.ct_icp_options, min_number_neighbors=10))
    if variant == "adaptive":
        return dataclasses.replace(o, sampling=jopt.SamplingOption.ADAPTIVE)
    if variant == "none":
        return dataclasses.replace(o, sampling=jopt.SamplingOption.NONE)
    if variant == "cap":
        return dataclasses.replace(o, max_num_keypoints=300)
    o = dataclasses.replace(o, sampling=jopt.SamplingOption.ADAPTIVE,
                            robust_registration=True, robust_num_attempts=3)
    if variant == "adaptive_escalation":
        # every attempt fails its assessment: each frame escalates through
        # all three levels and keeps the last attempt
        o = dataclasses.replace(o, distance_error_threshold=1e-4)
    return o


def _jax_scores(seed: int, n: int):
    return torch.from_numpy(np.array(
        jax.random.uniform(jax.random.PRNGKey(seed), (n,))))


def _run(odo, frames):
    """(keypoints, success, attempts, robust level, inserted) and the map
    size, frame by frame."""
    out, sizes = [], []
    for i, f in enumerate(frames):
        s = odo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
        out.append((s.sample_size, s.success, s.number_of_attempts,
                    s.robust_level, s.points_added))
        sizes.append(odo.map_size())
    return out, sizes


@pytest.mark.parametrize("variant", ["adaptive", "none", "cap",
                                     "adaptive_robust",
                                     "adaptive_escalation"])
def test_staged_path_matches_reference(variant, frames):
    jo = _staged(variant)
    to = options_from_dict(dataclasses.asdict(jo))
    jodo = JOdometry(jo)
    todo = TOdometry(to, device="cpu")
    assert not todo._fused_available and not jodo._fused_available
    todo._cap_scores = _jax_scores
    f0 = frames[0]
    jodo.register_frame(f0["xyz"], f0["timestamps"], frame_id=0)
    todo.register_frame(f0["xyz"], f0["timestamps"], frame_id=0)
    jl, tl = jodo.map_state.levels[0], todo.map_state[0]
    np.testing.assert_array_equal(tl.keys.numpy(),
                                  np.asarray(jl.keys).view(np.int32))
    np.testing.assert_array_equal(tl.points.numpy(), np.asarray(jl.points))
    # the escalating run: 4 frames, three attempts each
    n = 4 if variant == "adaptive_escalation" else N_FRAMES
    want, want_sizes = _run(jodo, frames[1:n])
    got, got_sizes = _run(todo, frames[1:n])
    assert got == want
    for a, b in zip(got_sizes, want_sizes):
        assert abs(a - b) <= 2e-3 * b
    assert len(got) == n - 1
    assert (todo.next_robust_level, todo.robust_num_consecutive_failures) \
        == (jodo.next_robust_level, jodo.robust_num_consecutive_failures)
    if variant == "adaptive_escalation":
        assert [r[2] for r in got] == [3] * (n - 1)
        assert max(r[3] for r in got) >= 2
    else:
        assert all(r[1] for r in got)
    assert todo.result_reads >= N_FRAMES - 1
    for a, b in zip(todo.trajectory, jodo.trajectory):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3
        assert a.end_pose.angular_distance(b.end_pose) < 0.05
    # the frames moved: the comparison is not of identities
    assert todo.trajectory[-1].end_pose.location_distance(
        todo.trajectory[0].end_pose) > 0.05 * n


def test_staged_callbacks_see_the_keypoints(frames):
    """BEFORE_ITERATION and ITERATION_COMPLETED fire once an attempt with
    the keypoints the solver takes, as the reference's do; FINISHED once a
    frame."""
    to = options_from_dict(dataclasses.asdict(_staged("adaptive")))
    odo = TOdometry(to, device="cpu")
    seen = {TOdometry.BEFORE_ITERATION: [], TOdometry.ITERATION_COMPLETED: [],
            TOdometry.FINISHED_REGISTRATION: []}
    for event, log in seen.items():
        odo.register_callback(
            event, lambda o, s, kp, log=log: log.append(kp) or True)
    for i, f in enumerate(frames[:3]):
        s = odo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
    raw, alphas, valid = seen[TOdometry.ITERATION_COMPLETED][-1]
    assert int(valid.sum()) == s.sample_size > 0
    assert raw.shape == (to.max_keypoints, 3) == (alphas.shape[0], 3)
    assert len(seen[TOdometry.BEFORE_ITERATION]) == 2
    assert len(seen[TOdometry.FINISHED_REGISTRATION]) == 3


def test_stream_and_unported_options_raise(frames):
    to = options_from_dict(dataclasses.asdict(_staged("adaptive")))
    odo = TOdometry(to, device="cpu")
    prep = odo.prepare_frame(frames[0]["xyz"], frames[0]["timestamps"], 0)
    with pytest.raises(ValueError, match="fused frame step"):
        list(odo.stream_frames(iter([prep]), batch=4))
    base = options_from_dict(dataclasses.asdict(_jax_options()))
    cv = dataclasses.replace(
        base, motion_compensation=type(base.motion_compensation)
        .CONSTANT_VELOCITY)
    # ported: they build, on the fused path
    assert TOdometry(cv, device="cpu")._use_fused
    assert TOdometry(dataclasses.replace(base, profile_registration=True),
                     device="cpu")._use_fused
