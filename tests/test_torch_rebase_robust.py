"""The speculative robust streamer's deferred rebase: ct_icp_torch's
``stream_frames`` (CPU, plain kernel versions) against ct_icp_tpu's on the
same prepared frames, with rebase distances that the drives cross.

  * "rebase": test_torch_robust_stream.py's gentle drive (batch 4, every
    batch commits whole at level 0) crosses 0.06 m in each batch: the
    first batch resolves "rebase" with the second in flight (its
    checkpoint is restored, the rebase applied, the batch dispatched
    again), the last one rebases with nothing in flight;
  * "levelchange_rebase": test_torch_robust_levelchange.py's turn, then
    straight (batch 2): the batch of frames 2-3 commits whole at level 1,
    its frame 3 implies level 0 and ends past 0.5 m; the batch of frames
    4-5 in flight is restored, the map rebased, the batch dispatched again
    at level 0.
Attempts, levels, success, commits by level, prefix commits and rollbacks
are equal to the reference's, and so are the rebases and the frames they
follow; end poses agree within 5 mm (float32 sums in another order), the
origins within the same.
"""

import dataclasses

import numpy as np
import pytest

from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.odometry import odometry as todom
from ct_icp_torch.odometry import pipeline as tpl
from ct_icp_tpu.odometry import pipeline as jpl
from test_torch_robust import both, outcome, robust_options, room_frames
# the autouse fixture, imported so that it applies here too
from test_torch_robust import single_torch_thread  # noqa: F401
from test_torch_robust_levelchange import turn_then_straight_frames
from test_torch_robust_stream import stream


def _rebase_frames(odo, name):
    """The registration ids of the frames after which ``odo`` rebases with
    its bound method ``name``."""
    calls = []
    inner = getattr(odo, name)

    def spy(*args):
        calls.append(len(odo.trajectory) - 1)
        return inner(*args)

    setattr(odo, name, spy)
    return calls


@pytest.mark.parametrize("case", ["rebase", "levelchange_rebase"])
def test_robust_streaming_rebase_matches_reference(case, monkeypatch):
    if case == "rebase":
        frames = room_frames(8, angle_span=np.pi / 24, off_edges=True)
        batch, distance, committed = 4, 0.06, {0: 2}
    else:
        frames = turn_then_straight_frames(6)
        batch, distance, committed = 2, 0.5, {1: 1, 0: 1}
    restores = []
    restore = tpl.restore
    monkeypatch.setattr(tpl, "restore",
                        lambda *a: restores.append(1) or restore(*a))
    jodo, todo = both(robust_options())
    # the reference makes its stream rebase on first use: make it now, to
    # watch it
    jodo._stream_rebase = jpl.make_stream_rebase_fn(jodo.map_options)
    j_stream = _rebase_frames(jodo, "_stream_rebase")
    j_frame = _rebase_frames(jodo, "_rebase")
    t_stream = _rebase_frames(todo, "_stream_rebase")
    t_frame = _rebase_frames(todo, "_rebase")
    for odo in (jodo, todo):
        odo.rebase_distance = distance
    (js, jpf), (ts, tpf) = (stream(jodo, frames, batch=batch),
                            stream(todo, frames, batch=batch))
    assert [outcome(s) for s in ts] == [outcome(s) for s in js]
    assert all(s.success for s in ts) and len(ts) == len(frames)
    assert tpf == jpf
    assert todo.speculative_batches_committed == \
        jodo.speculative_batches_committed == committed
    assert todo.speculative_prefix_commits == jodo.speculative_prefix_commits
    assert (t_stream, t_frame) == (j_stream, j_frame)
    assert todo.rebases == len(t_stream) + len(t_frame)
    if case == "rebase":
        # a deferred rebase with a batch in flight (the restore of its
        # checkpoint), then one at the end with nothing in flight
        assert t_stream == [3, 7] and t_frame == [] and len(restores) == 1
        assert todo.speculative_rollbacks == 0
    else:
        # frame 1's rollback, then the level change with the rebase
        assert [s.robust_level for s in ts] == [0, 1, 1, 1, 0, 0]
        assert t_stream == [3] and tpf == [1]
        assert todo.speculative_rollbacks == 1 and len(restores) == 2
    assert todo.next_robust_level == jodo.next_robust_level
    assert np.linalg.norm(todo.origin - jodo.origin) < 5e-3
    assert np.array_equal(todo.origin,
                          todo.trajectory[t_stream[-1]].end_pose.tr)
    for a, b in zip(todo.get_trajectory(), jodo.get_trajectory()):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3
        assert a.end_pose.angular_distance(b.end_pose) < 0.05


def test_streamed_rebase_keeps_the_map_with_the_origin():
    """The port alone: the same drive with and without the deferred
    rebases gives the same poses within 5 mm, and the state that seeds the
    next batch holds the last frame's pose relative to the new origin."""
    frames = room_frames(8, angle_span=np.pi / 24, off_edges=True)
    opts = options_from_dict(dataclasses.asdict(robust_options()))
    runs = []
    for distance in (0.06, 500.0):
        odo = todom.Odometry(opts, device="cpu")
        odo.rebase_distance = distance
        stream(odo, frames, batch=4)
        runs.append(odo)
    moved, still = runs
    assert moved.rebases == 2 and still.rebases == 0
    for a, b in zip(moved.get_trajectory(), still.get_trajectory()):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3
    state = moved._odo_state_from_host().numpy()
    last = moved.trajectory[-1].end_pose.tr - moved.origin
    np.testing.assert_allclose(state[11:14], last, atol=1e-6)
    # the rebuilt map is smaller: rows whose first points share a voxel
    # after the shift merge (the reference's row-level rehash)
    assert 0 < moved.map_size() < still.map_size()
