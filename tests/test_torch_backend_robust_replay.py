"""The CT-BA backend with replay on a robust profile, streamed: ct_icp_torch
(CPU, plain kernel versions) against ct_icp_tpu, ``stream_frames(batch=4)``
over the room of tests/test_torch_robust.py, 8 frames, window 4, period 3.

Here the one refinement fires while the speculative batch of frames 4-7
commits its prefix, and its replay (frames 2-5) runs on that batch's map.
Frame 6 then fails its assessment, and the batch rolls back to the
checkpoint taken when it was dispatched, before the replay. Both packages
restore that checkpoint and re-run the prefix, so the replay's evictions
and re-inserts are lost from the map while the frame ring keeps the
refined poses (ROADMAP §C). The test holds the two packages to the same
outcomes, rollbacks, replays and returned counts, the same ring, the map's
keys, counts and num_points bit for bit (its points within 5 mm: the two
solvers' poses differ by tens of micrometres), and the poses within 5 mm
and 0.05 deg.
"""

import dataclasses

import numpy as np

from ct_icp_torch import convert
from ct_icp_torch.odometry import pipeline as tpl
from test_torch_backend_robust import _assert_poses, _options
from test_torch_robust import both, room_frames
# the autouse fixture, imported so that it applies here too
from test_torch_robust import single_torch_thread  # noqa: F401

STREAM_FRAMES = 8


def _spy_replays(odo, restores):
    """Record each replay's frames, returned count and the rollbacks made
    before it."""
    rec = []
    inner = odo.replay_refined_frames

    def replay(frames):
        n = inner(frames)
        rec.append(([f.end_pose.frame_id for f in frames], n, len(restores)))
        return n

    odo.replay_refined_frames = replay
    return rec


def test_robust_backend_replay_streamed_matches_reference(monkeypatch):
    jo = _options()
    jo = dataclasses.replace(jo, backend=dataclasses.replace(
        jo.backend, replay=True))
    frames = room_frames(STREAM_FRAMES)
    jodo, todo = both(jo)
    restores = []
    restore = tpl.restore

    def counted_restore(map_state, ckpt):
        restores.append(len(todo.trajectory))
        return restore(map_state, ckpt)

    monkeypatch.setattr(tpl, "restore", counted_restore)
    jrec, trec = _spy_replays(jodo, []), _spy_replays(todo, restores)
    jpreps = [jodo.prepare_frame(f["xyz"], f["timestamps"], i, upload=False)
              for i, f in enumerate(frames)]
    tpreps = [todo.prepare_frame(f["xyz"], f["timestamps"], i)
              for i, f in enumerate(frames)]
    ts = list(todo.stream_frames(iter(tpreps), batch=4))
    js = list(jodo.stream_frames(iter(jpreps), batch=4))
    assert all(s.success for s in ts) and len(ts) == len(frames)
    assert [(s.number_of_attempts, s.robust_level, s.points_added)
            for s in ts] == [(s.number_of_attempts, s.robust_level,
                              s.points_added) for s in js]
    assert todo.speculative_prefix_commits == \
        jodo.speculative_prefix_commits >= 1
    assert todo.backend.refinements == jodo.backend.refinements >= 1
    assert [r[:2] for r in trec] == [r[:2] for r in jrec]
    assert any(n > 0 for _, n, _ in trec)
    # a batch rolled back after a replay had run on its map
    assert any(before < len(restores) for _, _, before in trec)
    assert todo.frame_ring.frame_ids() == jodo.frame_ring.frame_ids()
    for fid in todo.frame_ring.frame_ids():
        a, b = todo.frame_ring.get_frame(fid), jodo.frame_ring.get_frame(fid)
        for key in ("begin_pose", "end_pose"):
            assert np.abs(a[key].tr - b[key].tr).max() < 5e-3
        assert np.abs(a["world"] - b["world"]).max() < 5e-3
    for jl, tl in zip(jodo.map_state.levels,
                      convert.map_state_to_numpy(todo.map_state)):
        for f in ("keys", "count", "num_points"):
            assert np.array_equal(np.asarray(getattr(jl, f)), tl[f]), f
        assert np.abs(np.asarray(jl.points) - tl["points"]).max() < 5e-3
    _assert_poses(jodo.get_trajectory(), todo.get_trajectory())
