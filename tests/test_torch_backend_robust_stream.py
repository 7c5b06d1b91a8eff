"""The CT-BA backend on a robust profile, streamed: ct_icp_torch (CPU, plain
kernel versions) against ct_icp_tpu, ``stream_frames(batch=4)`` over the
room of tests/test_torch_robust.py (speculation at levels 0 and 1,
rollbacks, per-frame replays).

One callback for each committed frame and none for a rolled-back one. The
keypoints of frames committed from a speculative batch are the host
prefix, of frames replayed per frame the kept attempt's. A frame committed
from a speculative batch at level 1 ran the device election, and both
packages still hand the backend the host prefix there: the reference's
``_host_keypoints`` does not check the sample voxel, and the port keeps
that (ROADMAP §C). Every frame's keypoints are held bit for bit (as
tests/test_torch_backend_robust.py does), the refinements and windows
equal, and the poses within 5 mm and 0.05 deg.
"""

import numpy as np

from test_torch_backend_robust import (_assert_kp_equal, _assert_poses,
                                       _options, _spy)
from test_torch_robust import both, room_frames
# the autouse fixture, imported so that it applies here too
from test_torch_robust import single_torch_thread  # noqa: F401

STREAM_FRAMES = 8


def test_robust_backend_streamed_matches_reference():
    frames = room_frames(STREAM_FRAMES)
    jodo, todo = both(_options())
    jrec, trec = _spy(jodo), _spy(todo)
    jpreps = [jodo.prepare_frame(f["xyz"], f["timestamps"], i, upload=False)
              for i, f in enumerate(frames)]
    tpreps = [todo.prepare_frame(f["xyz"], f["timestamps"], i)
              for i, f in enumerate(frames)]
    committed = {}       # frames committed from a speculative batch
    inner = todo._finish_streamed

    def finish(info, r, origin, allow_rebase=True):
        summary = inner(info, r, origin, allow_rebase)
        committed[info.registered_fid] = summary
        return summary

    todo._finish_streamed = finish
    ts = list(todo.stream_frames(iter(tpreps), batch=4))
    js = list(jodo.stream_frames(iter(jpreps), batch=4))
    assert all(s.success for s in ts) and len(ts) == len(frames)
    assert [(s.number_of_attempts, s.robust_level) for s in ts] == \
        [(s.number_of_attempts, s.robust_level) for s in js]
    assert todo.speculative_batches_committed == \
        jodo.speculative_batches_committed
    assert todo.speculative_rollbacks > 0
    # one callback for each committed frame, none for a rolled-back one
    assert [k for k, _ in trec["kps"]] == [k for k, _ in jrec["kps"]] \
        == list(range(len(frames)))
    assert trec["windows"] == jrec["windows"] and trec["windows"]
    jtraj, ttraj = jodo.get_trajectory(), todo.get_trajectory()  # applies
    assert todo.backend.refinements == jodo.backend.refinements >= 1
    escalated = [k for k, s in committed.items() if s.robust_level >= 1]
    assert escalated, "no frame committed from an escalated speculative batch"
    refined = {f for w in trec["windows"] for f in w}
    assert refined & set(escalated)
    # those frames get their host prefix (numpy, the prep's kp_n rows)
    for k in escalated:
        kp = committed[k].keypoints
        assert isinstance(kp[0], np.ndarray)
        assert int(kp[2].sum()) == min(tpreps[k]["kp_n"],
                                       todo.options.max_keypoints)
    for (k, a), (_, b) in zip(jrec["kps"], trec["kps"]):
        _assert_kp_equal(a, b)
    _assert_poses(jtraj, ttraj)
