"""Speculative robust streaming across a level change: ct_icp_torch's
``stream_frames(batch=2)`` (CPU, plain kernel versions) against
ct_icp_tpu's on the same prepared frames.

The sensor turns at 4 deg a frame, above the robust rotation threshold
(3 deg), through frame 2, then drives straight. Frame 1 fails at robust
level 0: its batch commits frame 0, rolls back and replays frame 1, which
passes at level 1. The batch of frames 2-3 then commits whole at level 1,
but frame 3 (straight) implies level 0 while the batch of frames 4-5 is
already in flight at level 1: the streamer restores that batch's
checkpoint and dispatches it again at level 0 (the "levelchange"
re-dispatch). Its own file: batch 2 compiles another ct_icp_tpu
multi-frame step.
"""

import numpy as np

from ct_icp_torch.odometry import pipeline as tpl
from ct_icp_tpu.core import se3_np as s3n
from ct_icp_tpu.core.pose import Pose
from ct_icp_tpu.core.trajectory import LinearContinuousTrajectory
from ct_icp_tpu.datasets import synthetic as syn
from test_torch_robust import both, outcome, robust_options, room_prims
# the autouse fixture, imported so that it applies here too
from test_torch_robust import single_torch_thread  # noqa: F401
from test_torch_robust_stream import inserted, stream

TURN_DEG_PER_FRAME = 4.0
TURN_FRAMES = 3


def turn_then_straight_frames(n, seed=11):
    """test_torch_robust's room off the voxel edges, the sensor at 1.45 m
    moving at 2 m/s, turning through the first TURN_FRAMES frames."""
    rate = np.radians(TURN_DEG_PER_FRAME) / 0.1
    poses = []
    for t in np.linspace(0.0, n * 0.1 + 0.2, 200):
        yaw = rate * min(t, TURN_FRAMES * 0.1)
        pos = np.array([-6.0 + 2.0 * t, -3.0, 1.45])
        poses.append(Pose(s3n.quat_from_rotvec(np.array([0.0, 0.0, yaw])),
                          pos, timestamp=t))
    acq = syn.SyntheticSensorAcquisition(
        syn.Scene(room_prims(off_edges=True)),
        LinearContinuousTrajectory(poses),
        syn.SyntheticAcquisitionOptions(num_points_per_frame=6000,
                                        frame_duration=0.1, max_range=60.0),
        seed=seed)
    return [acq.frame(i) for i in range(n)]


def test_robust_streaming_levelchange_redispatch(monkeypatch):
    restores = []
    restore = tpl.restore

    def spy(*args):
        restores.append(1)
        return restore(*args)

    monkeypatch.setattr(tpl, "restore", spy)
    frames = turn_then_straight_frames(6)
    jodo, todo = both(robust_options())
    (js, jpf), (ts, tpf) = (stream(jodo, frames, batch=2),
                            stream(todo, frames, batch=2))
    assert [outcome(s) for s in ts] == [outcome(s) for s in js]
    assert all(s.success for s in ts) and len(ts) == len(frames)
    assert [s.robust_level for s in ts] == [0, 1, 1, 1, 0, 0]
    assert tpf == jpf == [1]
    assert todo.speculative_batches_committed == \
        jodo.speculative_batches_committed == {1: 1, 0: 1}
    assert todo.speculative_prefix_commits == \
        jodo.speculative_prefix_commits == 1
    # one rollback, and one restore beside it: the level change
    assert todo.speculative_rollbacks == 1 and len(restores) == 2
    assert todo.next_robust_level == jodo.next_robust_level
    assert np.array_equal(inserted(ts), inserted(js))
    assert todo.map_size() == jodo.map_size()
    for a, b in zip(todo.get_trajectory(), jodo.get_trajectory()):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3
        assert a.end_pose.angular_distance(b.end_pose) < 0.05
