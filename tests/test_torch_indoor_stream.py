"""The indoor walk streamed speculatively (``stream_frames(batch=4)``):
ct_icp_torch (CPU, plain kernel versions) against ct_icp_tpu on the same
frames, with the low-inertia profile's three-level map (the options and
frames of ``test_torch_indoor.py``).

Eight frames from frame 18 of the walk: the stream reaches the first
doorway turn, where a frame escalates to robust level 1 and its escalated
attempt elects keypoints on the device (K4's plain version). Attempts,
robust levels, success, insert decisions, points inserted, the commit
counters and every level's size are equal; end poses agree within 5 mm
and 0.05 deg (float32 sums in another order move the solver's iterates
slightly).
"""

import pytest

from ct_icp_torch.kernels import grid_sample as k4
from test_torch_indoor import indoor_frames, indoor_options, stream_both
# the autouse fixture, imported so that it applies here too
from test_torch_indoor import single_torch_thread  # noqa: F401


@pytest.fixture
def election_calls(monkeypatch):
    """The device keypoint elections the port runs."""
    calls = []
    plain = k4.grid_sample_plain

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return plain(*args, **kw)

    monkeypatch.setattr(k4, "grid_sample_plain", spy)
    return calls


def outcome(s):
    return (s.number_of_attempts, s.robust_level, s.success, s.points_added,
            s.logged_values.get("map_inserted_points", -1))


def test_indoor_stream_matches_reference(election_calls):
    frames = indoor_frames(8)
    (jodo, js), (todo, ts) = stream_both(indoor_options(), frames)
    assert [outcome(s) for s in ts] == [outcome(s) for s in js]
    assert all(s.success for s in ts) and len(ts) == len(frames)
    # the turn escalated, and the escalated attempt ran the election
    assert max(s.number_of_attempts for s in ts) > 1
    assert max(s.robust_level for s in ts) >= 1 and election_calls
    assert todo.speculative_batches_committed == \
        jodo.speculative_batches_committed
    assert todo.speculative_prefix_commits == \
        jodo.speculative_prefix_commits
    assert (todo.next_robust_level, todo.robust_num_consecutive_failures) \
        == (jodo.next_robust_level, jodo.robust_num_consecutive_failures)
    assert [int(lv.num_points[0]) for lv in todo.map_state] == \
        [int(lv.num_points.reshape(-1)[0]) for lv in jodo.map_state.levels]
    for a, b in zip(todo.get_trajectory(), jodo.get_trajectory()):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3
        assert a.end_pose.angular_distance(b.end_pose) < 0.05
    traj = todo.get_trajectory()
    assert traj[-1].end_pose.location_distance(traj[0].end_pose) > 0.3
