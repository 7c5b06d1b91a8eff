"""The backend replay streamed in batches of 3 (``stream_frames``): the
port against ct_icp_tpu on the room of the reference's replay test, 9
frames, as tests/test_torch_replay.py holds the per-frame path.

This settles the question of ROADMAP §C. The reference's batched streamer
sets its map to batch k + 1's output before it finishes batch k
(odometry.py:790-797), so a replay fired while batch k finishes applies on
top of batch k + 1's inserts, and batch k + 2 starts from the replayed map.
The port's map is updated in place on one stream, so its replay also runs
after batch k + 1's inserts: the two agree (same refinements, same replayed
frames, poses within 5 mm and 0.05 deg).
"""

from test_torch_replay import (check_replay_stream, gate_frames,  # noqa: F401
                               single_torch_thread)


def test_streamed_replay_matches_reference(gate_frames):  # noqa: F811
    check_replay_stream(gate_frames, batch=3)
