"""The port's frame ring (``ct_icp_torch/mapping/frame_ring.py``) and
``Pose.continuous_transform`` against ct_icp_tpu's, on the same numpy
inputs from a seed: the retained ids and their eviction order, the world
points (float64, within 1e-9 m) after the same pushes and after
``update_trajectory``, ``all_world_points``, ``clear``, and the round trip
through ``convert.frame_ring_to_numpy`` / ``frame_ring_from_numpy``.
"""

import numpy as np
import pytest

from ct_icp_torch import convert
from ct_icp_torch.core import pose as tpose
from ct_icp_torch.mapping.frame_ring import FrameRing as TRing
from ct_icp_tpu.core import pose as jpose
from ct_icp_tpu.mapping.frame_ring import FrameRing as JRing

WORLD_ATOL_M = 1e-9


def _frame(mod, rng, fid, t0):
    """A random (begin, end) pose pair over [t0, t0 + 0.1] in ``mod``'s
    classes (the same numbers for both packages: drawn once, outside)."""
    def pose(q, t, ts):
        return mod.Pose(q / np.linalg.norm(q), t, ts, fid)
    q0, q1 = rng[0], rng[1]
    return mod.TrajectoryFrame(pose(q0, rng[2], t0), pose(q1, rng[3],
                                                         t0 + 0.1))


def _draws(seed, n_frames, n_points=300):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_frames):
        q = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0, 0.05, (2, 4))
        t = rng.normal(0, 3.0, (2, 3))
        xyz = rng.normal(0, 10.0, (n_points + 7 * k, 3))
        ts = np.sort(rng.uniform(0.1 * k, 0.1 * k + 0.1, xyz.shape[0]))
        out.append(((q[0], q[1], t[0], t[1]), xyz, ts))
    return out


def _fill(max_frames, draws, ids):
    j, t = JRing(max_frames), TRing(max_frames)
    for fid, (poses, xyz, ts) in zip(ids, draws):
        j.push(fid, xyz, ts, _frame(jpose, poses, fid, 0.1 * fid))
        t.push(fid, xyz, ts, _frame(tpose, poses, fid, 0.1 * fid))
    return j, t


def _assert_same(j, t):
    assert t.frame_ids() == j.frame_ids()
    assert len(t) == len(j)
    for fid in j.frame_ids():
        a, b = j.get_frame(fid), t.get_frame(fid)
        assert np.array_equal(a["xyz"], b["xyz"])
        assert np.array_equal(a["timestamps"], b["timestamps"])
        assert (a["min_t"], a["max_t"]) == (b["min_t"], b["max_t"])
        for key in ("begin_pose", "end_pose"):
            assert np.array_equal(a[key].quat, b[key].quat)
            assert np.array_equal(a[key].tr, b[key].tr)
        np.testing.assert_allclose(b["world"], a["world"], rtol=0,
                                   atol=WORLD_ATOL_M)
    np.testing.assert_allclose(t.all_world_points(), j.all_world_points(),
                               rtol=0, atol=WORLD_ATOL_M)


@pytest.mark.parametrize("seed", [0, 1])
def test_continuous_transform_matches_reference(seed):
    (poses, xyz, ts), = _draws(seed, 1, n_points=2000)
    # timestamps beyond the frame's span clamp as the reference's do
    ts = np.concatenate([ts[:-2], [-1.0, 5.0]])
    fj = _frame(jpose, poses, 3, 0.0)
    ft = _frame(tpose, poses, 3, 0.0)
    a = fj.begin_pose.continuous_transform(xyz, fj.end_pose, ts)
    b = ft.begin_pose.continuous_transform(xyz, ft.end_pose, ts)
    np.testing.assert_allclose(b, a, rtol=0, atol=WORLD_ATOL_M)


@pytest.mark.parametrize("max_frames,ids", [
    (4, [0, 1, 2, 3, 4, 5, 6]),
    (3, [2, 5, 9, 11]),
    (8, [0, 1, 2]),
])
def test_ring_pushes_and_eviction_match_reference(max_frames, ids):
    j, t = _fill(max_frames, _draws(7, len(ids)), ids)
    assert t.frame_ids() == ids[-max_frames:]
    _assert_same(j, t)
    assert t.get_frame(ids[0] - 1) is None and j.get_frame(ids[0] - 1) is None


def test_update_trajectory_matches_reference():
    ids = [0, 1, 2, 3, 4, 5]
    j, t = _fill(4, _draws(3, len(ids)), ids)
    # refined poses for frames 1, 3 and 5, and one for a frame not retained
    refined = _draws(4, 4)
    upd_j = [_frame(jpose, r[0], fid, 0.1 * fid)
             for r, fid in zip(refined, [1, 3, 5, 9])]
    upd_t = [_frame(tpose, r[0], fid, 0.1 * fid)
             for r, fid in zip(refined, [1, 3, 5, 9])]
    before = {fid: t.get_frame(fid)["world"] for fid in t.frame_ids()}
    j.update_trajectory(upd_j)
    t.update_trajectory(upd_t)
    _assert_same(j, t)
    assert np.array_equal(t.get_frame(2)["world"], before[2])
    assert not np.allclose(t.get_frame(3)["world"], before[3])
    j.clear()
    t.clear()
    assert len(t) == len(j) == 0
    assert t.all_world_points().shape == (0, 3)


def test_disabled_ring_keeps_nothing():
    j, t = _fill(0, _draws(5, 2), [0, 1])
    assert not t.enabled and not j.enabled
    assert len(t) == len(j) == 0


def test_ring_round_trip_through_numpy():
    ids = [4, 5, 6]
    j, t = _fill(5, _draws(9, len(ids)), ids)
    records = [(fid, j.get_frame(fid, world=False)) for fid in j.frame_ids()]
    back = convert.frame_ring_from_numpy(records, 5)
    _assert_same(j, back)
    again = convert.frame_ring_from_numpy(convert.frame_ring_to_numpy(t), 5)
    _assert_same(j, again)
    for (fid, rec), want in zip(convert.frame_ring_to_numpy(t), ids):
        assert fid == want
        np.testing.assert_allclose(rec["world"], j.get_frame(fid)["world"],
                                   rtol=0, atol=WORLD_ATOL_M)
