"""Speculative robust streaming: ct_icp_torch's ``stream_frames(batch=4)``
(CPU, plain kernel versions) against ct_icp_tpu's on the same prepared
frames — the 2-deep speculation, the checkpoint, the prefix commit, the
map-neutral re-run, the rollback and the per-frame replay.

Semantic bounds as tests/test_odometry.py:127-231 holds the reference to:
equal attempts, robust levels and success per frame, equal commit
counters, the same frames replayed per frame, end poses within 5 mm, and
equal points inserted per frame and map sizes, in the room moved off the
voxel edges (``room_prims``).
"""

import numpy as np

from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from test_torch_robust import both, outcome, robust_options, room_frames
# the autouse fixture, imported so that it applies here too
from test_torch_robust import single_torch_thread  # noqa: F401


def stream(odo, frames, batch=4):
    """``odo.stream_frames`` over ``frames``: the summaries, and the
    registration ids of the frames that went through the per-frame path
    (replays after a rollback, drains, the tail)."""
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i)
             for i, f in enumerate(frames)]
    per_frame = []
    inner = odo.register_frame_prepared

    def spy(prep, *args):
        per_frame.append(prep["info"].registered_fid)
        return inner(prep, *args)

    odo.register_frame_prepared = spy
    out = list(odo.stream_frames(iter(preps), batch=batch))
    del odo.register_frame_prepared
    return out, per_frame


def inserted(summaries):
    return np.array([s.logged_values.get("map_inserted_points", -1)
                     for s in summaries])


def test_robust_streaming_matches_reference():
    """A gentle drive: every batch commits whole at robust level 0, two in
    flight at a time."""
    frames = room_frames(8, angle_span=np.pi / 24, off_edges=True)
    jodo, todo = both(robust_options())
    (js, jpf), (ts, tpf) = stream(jodo, frames), stream(todo, frames)
    assert [outcome(s) for s in ts] == [outcome(s) for s in js]
    assert all(s.success for s in ts) and len(ts) == len(frames)
    assert tpf == jpf == []
    assert todo.speculative_batches_committed == \
        jodo.speculative_batches_committed == {0: 2}
    assert todo.speculative_prefix_commits == \
        jodo.speculative_prefix_commits == 0
    assert todo.speculative_rollbacks == 0
    for a, b in zip(todo.get_trajectory(), jodo.get_trajectory()):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3
        assert a.end_pose.angular_distance(b.end_pose) < 0.05
    assert todo.next_robust_level == jodo.next_robust_level
    assert todo.map_size() == jodo.map_size() > 1000


def test_robust_streaming_rollback_replay():
    """An impossible distance threshold fails every speculative batch's
    device assessment: the streamer commits the first batch's prefix (frame
    0, which does not register), rolls the map back to the batch's
    checkpoint with the second batch already in flight, re-runs the prefix,
    replays the rest per frame, then rolls the second batch back whole and
    replays it; each replayed attempt exhausts and its points go in by the
    deferred map update. The port agrees with the reference's stream, and
    ends in exactly the state of its own per-frame path."""
    frames = room_frames(8, angle_span=np.pi / 24, off_edges=True)
    opts = robust_options(robust_num_attempts=1,
                          distance_error_threshold=1e-4)
    jodo, todo = both(opts)
    (js, jpf), (ts, tpf) = stream(jodo, frames), stream(todo, frames)
    assert [outcome(s) for s in ts] == [outcome(s) for s in js]
    assert tpf == jpf == list(range(1, len(frames)))
    assert todo.speculative_prefix_commits == \
        jodo.speculative_prefix_commits == 1
    assert todo.speculative_rollbacks == 2
    assert todo.speculative_batches_committed == \
        jodo.speculative_batches_committed == {}
    assert todo.robust_num_consecutive_failures == \
        jodo.robust_num_consecutive_failures == len(frames) - 1
    assert todo.next_robust_level == jodo.next_robust_level
    assert np.array_equal(inserted(ts), inserted(js))
    assert todo.map_size() == jodo.map_size()
    ta, tb = todo.get_trajectory(), jodo.get_trajectory()
    assert len(ta) == len(tb) == len(frames)
    for a, b in zip(ta, tb):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3

    per_frame = TOdometry(todo.options, device="cpu")
    for i, f in enumerate(frames):
        per_frame.register_frame(f["xyz"], f["timestamps"], frame_id=i)
    assert per_frame.map_size() == todo.map_size()
    for a, b in zip(per_frame.get_trajectory(), ta):
        assert a.end_pose.location_distance(b.end_pose) < 1e-5
