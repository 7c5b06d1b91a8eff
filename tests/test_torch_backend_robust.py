"""The CT-BA backend on a robust profile: ct_icp_torch (CPU, plain kernel
versions) against ct_icp_tpu on the room of tests/test_torch_robust.py,
whose rotation needs robust level 1 (escalated attempts elect their
keypoints on the device, off the host prefix).

* Per frame (``register_frame``): every kept frame fires the callback once,
  with the kept attempt's keypoints (the decimated prefix, or the device
  election where the attempt escalated); the keypoints the backend holds
  for each refined frame bit for bit on their valid rows (points, and the
  alphas' wire codes; the alphas themselves within 1 ulp, see
  ``_assert_kp_equal``; the reference hands over its device arrays); the
  same refinements and windows; end poses within 5 mm and 0.05 deg.

Streamed: tests/test_torch_backend_robust_stream.py.
"""

import dataclasses

import numpy as np
import torch

from test_torch_robust import both, robust_options, room_frames
# the autouse fixture, imported so that it applies here too
from test_torch_robust import single_torch_thread  # noqa: F401

POSE_ATOL_M = 5e-3
POSE_ATOL_DEG = 0.05
WINDOW, PERIOD = 4, 3


def _options():
    jo = robust_options()
    return dataclasses.replace(jo, backend=dataclasses.replace(
        jo.backend, enabled=True, window=WINDOW, period=PERIOD))


def _spy(odo):
    """Record each callback's (frame index, keypoints as numpy) and each
    refinement's window."""
    rec = {"kps": [], "windows": []}
    b = odo.backend
    inner_on, inner_refine = b._on_finished, b._refine

    def on_finished(o, summary, keypoints=None):
        kp = summary.keypoints
        if kp is not None:
            kp = tuple(np.asarray(a.cpu().numpy() if torch.is_tensor(a)
                                  else a) for a in kp)
        rec["kps"].append((len(o.trajectory) - 1, kp))
        return inner_on(o, summary, keypoints)

    def refine():
        rec["windows"].append([kp[0] for kp in b._keypoints
                               if kp[0] >= b.keep_first])
        inner_refine()

    odometry_cbs = odo.callbacks[type(odo).FINISHED_REGISTRATION]
    odometry_cbs[odometry_cbs.index(inner_on)] = on_finished
    b._refine = refine
    return rec


def _rows(kp):
    raw, alphas, valid = kp
    valid = np.asarray(valid) != 0
    return valid, np.asarray(raw)[valid], np.asarray(alphas)[valid]


def _codes(alphas):
    return np.rint(alphas.astype(np.float64) * 65535.0).astype(np.int64)


def _assert_kp_equal(a, b):
    """Valid rows, points and alphas' 16-bit wire codes bit for bit; the
    alphas within 1 ulp: the reference's device decode, jitted, divides by
    65535 in a way that rounds 512 of the 65,536 codes one ulp off an IEEE
    division, which the port's decode and both packages' host
    reconstructions are."""
    va, ra, aa = _rows(a)
    vb, rb, ab = _rows(b)
    assert np.array_equal(va, vb)
    assert np.array_equal(ra, rb)
    assert np.array_equal(_codes(aa), _codes(ab))
    np.testing.assert_array_max_ulp(ab, aa, maxulp=1)


def _assert_poses(ja, tb):
    assert len(ja) == len(tb)
    for a, b in zip(ja, tb):
        for key in ("begin_pose", "end_pose"):
            pa, pb = getattr(a, key), getattr(b, key)
            assert np.abs(pa.tr - pb.tr).max() < POSE_ATOL_M
            assert pa.angular_distance(pb) < POSE_ATOL_DEG


def test_robust_backend_per_frame_matches_reference():
    frames = room_frames(7)
    jodo, todo = both(_options())
    jrec, trec = _spy(jodo), _spy(todo)
    js = [jodo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
          for i, f in enumerate(frames)]
    ts = [todo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
          for i, f in enumerate(frames)]
    assert all(s.success for s in ts)
    assert [s.robust_level for s in ts] == [s.robust_level for s in js]
    assert max(s.robust_level for s in ts) >= 1
    # one callback a frame, the frames in order
    assert [k for k, _ in trec["kps"]] == [k for k, _ in jrec["kps"]] \
        == list(range(len(frames)))
    assert trec["windows"] == jrec["windows"] and trec["windows"]
    jtraj, ttraj = jodo.get_trajectory(), todo.get_trajectory()  # applies
    assert todo.backend.refinements == jodo.backend.refinements >= 1
    refined = {f for w in trec["windows"] for f in w}
    assert any(ts[f].robust_level >= 1 for f in refined)
    for (k, a), (_, b) in zip(jrec["kps"], trec["kps"]):
        if k in refined:
            _assert_kp_equal(a, b)
    _assert_poses(jtraj, ttraj)
