"""The backend replay of the port (``Odometry.replay_refined_frames``, kernel
K9 ``evict_voxels`` and K3 on the CPU through their plain versions) against
ct_icp_tpu's, on the same numpy inputs.

* ``evict_voxels`` on each level of a three-level map built by the
  reference (the room's frames inserted at their true poses) and converted:
  count, flags, keys, num_points and the points removed, bit for bit; the
  coordinates hold found, absent, repeated and masked voxels; and
  ``evict_levels`` (kernel K9's one launch over every level) on all three
  levels at once, each list with its own row count and a tail of real
  voxels past it, against the reference's eviction of each level.
* ``replay_refined_frames`` given the same map, the same frame ring and the
  same refined poses (a subset of the retained frames moved by a few cm and
  tenths of a degree), at the origin and off it, and with the distance
  strategy, whose re-inserts keep the voxel normals: every level's keys,
  counts, points, normals, flags and num_points, and the returned count,
  bit for bit (the refit normals within 2e-4).
* The room of the reference's replay test (tests/test_ct_ba.py:182-224) at
  the test's sizes, 9 frames with the degraded front end and the backend on
  (window 6, period 3, replay), per frame (streamed in batches of 3:
  tests/test_torch_replay_stream.py): the same refinements (count and
  windows), the same replayed frames, the points each replay re-inserts
  within 1 % (the refined poses differ by sub-millimetres), end poses within
  5 mm and 0.05 deg.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch import convert
from ct_icp_torch.core import pose as tpose
from ct_icp_torch.datasets import room
from ct_icp_torch.mapping import voxel_map as tvm
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_tpu.config.options import (BackendOptions,
                                       DistanceBasedStrategyOptions)
from ct_icp_tpu.core import pose as jpose
from ct_icp_tpu.mapping import voxel_map as jvm
from ct_icp_tpu.odometry import odometry as jodometry
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry

from test_odometry import make_acquisition, small_options

POSE_ATOL_M = 5e-3
POSE_ATOL_DEG = 0.05
STREAM_FRAMES = 9


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pad_pow2(a):
    n = max(a.shape[0], 1)
    m = 1 << (n - 1).bit_length()
    return np.concatenate([a, np.zeros((m - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


def _frame(mod, fr, fid, dq=None, dt=None):
    """A (begin, end) TrajectoryFrame of ``mod`` at ``fr``'s true poses,
    each moved by the rotation vector ``dq`` and translation ``dt``."""
    out = []
    for key in ("begin_pose", "end_pose"):
        p = fr[key]
        q, t = np.array(p.quat, np.float64), np.array(p.tr, np.float64)
        if dq is not None:
            half = 0.5 * np.asarray(dq)
            rot = np.concatenate([[1.0], half])
            rot /= np.linalg.norm(rot)
            w0, v0 = rot[0], rot[1:]
            w1, v1 = q[0], q[1:]
            q = np.concatenate([[w0 * w1 - v0 @ v1],
                                w0 * v1 + w1 * v0 + np.cross(v0, v1)])
            t = t + np.asarray(dt)
        out.append(mod.Pose(q, t, float(p.timestamp), fid))
    return mod.TrajectoryFrame(*out)


def build_room_maps(points=3000, frames=4, options=None):
    """Reference Odometries (``options``, small_options() when None) holding
    ``frames`` room frames of ``points`` points in their rings and those
    points (true poses) in their three-level maps, built at the origin and
    at an origin 3 m away; with the frames."""
    acq = room.make_acquisition(seed=5, noise=0.005,
                                points_per_frame=points)
    frames = [acq.frame(i) for i in range(frames)]
    out = {}
    for name, origin in (("origin", np.zeros(3)),
                         ("offset", np.array([2.0, -1.5, 0.5]))):
        jodo = JOdometry(small_options() if options is None else options)
        jodo.origin = origin.copy()
        levels = list(jodo.map_state.levels)
        for i, fr in enumerate(frames):
            xyz, ts = fr["xyz"], fr["timestamps"]
            tf = _frame(jpose, fr, i)
            jodo.frame_ring.push(i, xyz, ts, tf)
            w = tf.begin_pose.continuous_transform(xyz, tf.end_pose, ts)
            w = _pad_pow2(np.asarray(w - origin, np.float32))
            valid = np.arange(w.shape[0]) < xyz.shape[0]
            for li, rp in enumerate(jodo.map_options.resolutions):
                levels[li], _ = jodometry._jit_insert(
                    levels[li], jnp.asarray(w), jnp.asarray(valid),
                    jnp.float32(rp.resolution),
                    jnp.float32(rp.min_distance_between_points),
                    jnp.zeros(3, jnp.float32),
                    max_dirty=jodo.options.max_dirty_voxels,
                    with_normals=False, max_rounds=12)
        # flags on every occupied voxel, so that the eviction's zeroing shows
        levels = [lvl._replace(nflags=jnp.where(lvl.keys > 1, 3, 0).astype(
            jnp.int32)) for lvl in levels]
        jodo.map_state = jvm.MapState(levels=tuple(levels))
        out[name] = jodo
    return frames, out


@pytest.fixture(scope="module")
def room_map():
    """Four room frames, 3,000 points each, in the ring and the map."""
    return build_room_maps()


def _port_of(jodo):
    todo = TOdometry(convert.options_from_dict(
        dataclasses.asdict(jodo.options)), device="cpu")
    todo.map_state = convert.map_state_from_numpy(jodo.map_state.levels)
    todo.origin = jodo.origin.copy()
    ring = jodo.frame_ring
    todo.frame_ring = convert.frame_ring_from_numpy(
        [(fid, ring.get_frame(fid, world=False)) for fid in ring.frame_ids()],
        ring.max_frames)
    return todo


def _assert_levels_equal(jlevels, tlevels, normal_tol=0.0):
    """Every field bit for bit; the normals within ``normal_tol`` where the
    replay refit them (an eigensolve of float32 moments summed in another
    order: 2e-4, as tests/test_torch_sharded_map.py holds the refit)."""
    for jl, tl in zip(jlevels, convert.map_state_to_numpy(tlevels)):
        for f in ("keys", "count", "points", "nflags", "num_points"):
            assert np.array_equal(np.asarray(getattr(jl, f)), tl[f]), f
        np.testing.assert_allclose(tl["normals"], np.asarray(jl.normals),
                                   rtol=0, atol=normal_tol)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_evict_voxels_matches_reference(room_map, level):
    frames, odos = room_map
    jodo = odos["origin"]
    jl = jodo.map_state.levels[level]
    res = jodo.map_options.resolutions[level].resolution
    rng = np.random.default_rng(level)
    w = _frame(jpose, frames[1], 1).begin_pose.continuous_transform(
        frames[1]["xyz"], _frame(jpose, frames[1], 1).end_pose,
        frames[1]["timestamps"])
    coords = np.unique(np.trunc(w / res).astype(np.int32), axis=0)
    absent = coords[:40] + np.array([0, 0, 1000], np.int32)
    coords = np.concatenate([coords, absent, coords[:5]])   # repeated too
    coords = coords[rng.permutation(coords.shape[0])]
    coords = _pad_pow2(coords)
    valid = np.arange(coords.shape[0]) < coords.shape[0] - 7
    valid[::13] = False
    jl2, jremoved = jodometry._jit_evict(jl, jnp.asarray(coords),
                                         jnp.asarray(valid))
    tl = convert.map_state_from_numpy([jl])[0]
    tremoved = tvm.evict_voxels(tl, torch.as_tensor(coords),
                                torch.as_tensor(valid))
    assert int(tremoved[0]) == int(jremoved) > 0
    _assert_levels_equal([jl2], [tl])
    assert int(tl.num_points[0]) < int(np.asarray(jl.num_points))


def test_evict_levels_matches_reference(room_map):
    """The one-launch eviction of every level (its plain version here)
    against the reference's evict_voxels on each level of the room map:
    each level's list holds found voxels, absent ones and a coordinate
    listed twice, and past its row count a tail of real voxels (a replay's
    padding) that must stay. Keys, counts, flags, num_points and the points
    removed a level and in total, bit for bit."""
    frames, odos = room_map
    jodo = odos["origin"]
    rng = np.random.default_rng(17)
    w = _frame(jpose, frames[2], 2).begin_pose.continuous_transform(
        frames[2]["xyz"], _frame(jpose, frames[2], 2).end_pose,
        frames[2]["timestamps"])
    coords, counts, jlevels, jremoved = [], [], [], []
    for li, rp in enumerate(jodo.map_options.resolutions):
        c = np.unique(np.trunc(w / rp.resolution).astype(np.int32), axis=0)
        c = c[rng.permutation(c.shape[0])]
        keep, tail = c[: c.shape[0] // 2], c[c.shape[0] // 2:]
        absent = keep[:25] + np.array([0, 1000, 0], np.int32)
        listed = np.concatenate([keep, absent, keep[:3]])   # one twice
        listed = listed[rng.permutation(listed.shape[0])]
        rows = np.concatenate([listed, tail])
        padded = _pad_pow2(rows)
        n = listed.shape[0]
        jl2, jr = jodometry._jit_evict(
            jodo.map_state.levels[li], jnp.asarray(padded),
            jnp.asarray(np.arange(padded.shape[0]) < n))
        coords.append(torch.as_tensor(padded))
        counts.append(n)
        jlevels.append(jl2)
        jremoved.append(int(jr))
    tlevels = convert.map_state_from_numpy(jodo.map_state.levels)
    removed = tvm.evict_levels(tlevels, coords, counts)
    assert removed.tolist() == jremoved + [sum(jremoved)]
    assert min(jremoved) > 0
    _assert_levels_equal(jlevels, tlevels)


@pytest.mark.parametrize("case", ["origin", "offset", "normals"])
def test_replay_refined_frames_matches_reference(room_map, case):
    frames, odos = room_map
    jodo = odos[case if case != "normals" else "origin"]
    if case == "normals":
        # the distance strategy's solver reads the voxel normals, so the
        # replay's re-inserts keep them (reference odometry.py:556), each
        # oriented toward its refined frame's begin translation
        base = jodo
        jodo = JOdometry(dataclasses.replace(
            base.options, distance_strategy=DistanceBasedStrategyOptions()))
        jodo.map_state, jodo.frame_ring = base.map_state, base.frame_ring
        jodo.origin = base.origin.copy()
    snap = jodo.map_state
    todo = _port_of(jodo)
    moves = {1: ([0.004, -0.002, 0.006], [0.03, -0.02, 0.01]),
             3: ([-0.003, 0.005, 0.002], [-0.02, 0.04, -0.01])}
    refined_j = [_frame(jpose, frames[f], f, *moves[f]) for f in moves]
    refined_t = [_frame(tpose, frames[f], f, *moves[f]) for f in moves]
    try:
        nj = jodo.replay_refined_frames(refined_j)
        nt = todo.replay_refined_frames(refined_t)
        assert nt == nj > 0
        _assert_levels_equal(jodo.map_state.levels, todo.map_state,
                             2e-4 if case == "normals" else 0.0)
        assert todo.frame_ring.frame_ids() == jodo.frame_ring.frame_ids()
        for f in moves:
            np.testing.assert_array_equal(
                todo.frame_ring.get_frame(f)["begin_pose"].tr,
                jodo.frame_ring.get_frame(f)["begin_pose"].tr)
        stats = todo.replay_stats[-1]
        assert stats["frames"] == 2 and stats["inserted"] == nt
        assert stats["evicted"] > 0
        # one read a replay; with normals one more an insert (3 levels x 2
        # frames), each sizing its dirty list
        assert todo.host_syncs == (7 if case == "normals" else 1)
        if case == "normals":
            assert sum(int((lv.nflags == 2).sum())
                       for lv in todo.map_state) > 100
    finally:
        # the module's map is shared: put the reference's back
        jodo.map_state = snap
        for f in moves:
            jodo.frame_ring.update_trajectory([_frame(jpose, frames[f], f)])


def _gate_options(enabled=True):
    jo = small_options()
    jo = dataclasses.replace(
        jo, ct_icp_options=dataclasses.replace(
            jo.ct_icp_options, num_iters_icp=2, ls_max_num_iters=1),
        backend=BackendOptions(enabled=enabled, window=room.REPLAY_WINDOW,
                               period=room.REPLAY_PERIOD,
                               num_steps=room.REPLAY_STEPS, replay=True))
    return jo, convert.options_from_dict(dataclasses.asdict(jo))


def _spy(odo):
    """Record each refinement's keyframe ids and each replay's frames and
    returned count."""
    rec = {"windows": [], "replays": []}
    b = odo.backend
    inner_refine, inner_replay = b._refine, odo.replay_refined_frames

    def refine():
        rec["windows"].append([kp[0] for kp in b._keypoints
                               if kp[0] >= b.keep_first])
        inner_refine()

    def replay(frames):
        n = inner_replay(frames)
        rec["replays"].append(([f.end_pose.frame_id for f in frames], n))
        return n

    b._refine = refine
    odo.replay_refined_frames = replay
    return rec


def _run(odo, frames, batch):
    if batch == 0:
        return [odo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
                for i, f in enumerate(frames)]
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i,
                               **({} if isinstance(odo, TOdometry)
                                  else {"upload": False}))
             for i, f in enumerate(frames)]
    return list(odo.stream_frames(iter(preps), batch=batch))


@pytest.fixture(scope="module")
def gate_frames():
    acq = make_acquisition(seed=room.REPLAY_SEED, noise=room.REPLAY_NOISE)
    return [acq.frame(i) for i in range(STREAM_FRAMES)]


def test_replay_stream_matches_reference(gate_frames):
    """Per frame (register_frame): the path of the replay gate."""
    check_replay_stream(gate_frames, batch=0)


def check_replay_stream(gate_frames, batch):
    jo, to = _gate_options()
    jodo, todo = JOdometry(jo), TOdometry(to, device="cpu")
    jrec, trec = _spy(jodo), _spy(todo)
    js, ts = _run(jodo, gate_frames, batch), _run(todo, gate_frames, batch)
    assert all(s.success for s in ts) and all(s.success for s in js)
    assert [s.points_added for s in ts] == [s.points_added for s in js]
    assert todo.backend.refinements == jodo.backend.refinements >= 2
    assert trec["windows"] == jrec["windows"]
    assert [fids for fids, _ in trec["replays"]] == \
        [fids for fids, _ in jrec["replays"]]
    assert any(n > 0 for _, n in trec["replays"])
    # the counts re-inserted: the poses the two packages refine differ by
    # sub-millimetres, which moves a point across a voxel edge now and then
    # (the replay itself is bit for bit on the same inputs, above)
    for (_, a), (_, b) in zip(trec["replays"], jrec["replays"]):
        assert abs(a - b) <= 0.01 * b
    assert todo.frame_ring.frame_ids() == jodo.frame_ring.frame_ids()
    ta, tb = todo.get_trajectory(), jodo.get_trajectory()
    assert len(ta) == len(tb) == len(gate_frames)
    for a, b in zip(ta, tb):
        for key in ("begin_pose", "end_pose"):
            pa, pb = getattr(a, key), getattr(b, key)
            assert np.abs(pa.tr - pb.tr).max() < POSE_ATOL_M
            assert pa.angular_distance(pb) < POSE_ATOL_DEG


def test_room_matches_reference_acquisition():
    """``datasets/room.py`` is the reference test's room: the replay gate's
    frames (seed 47, 5 mm noise) bit for bit, and the gate's constants."""
    ours = room.make_acquisition(seed=room.REPLAY_SEED,
                                 noise=room.REPLAY_NOISE)
    theirs = make_acquisition(seed=47, noise=0.005)
    assert ours.num_frames() == theirs.num_frames() >= room.REPLAY_FRAMES
    for i in (0, room.REPLAY_FRAMES - 1):
        a, b = ours.frame(i), theirs.frame(i)
        assert np.array_equal(a["xyz"], b["xyz"])
        assert np.array_equal(a["timestamps"], b["timestamps"])
        for key in ("begin_pose", "end_pose"):
            assert np.array_equal(a[key].tr, b[key].tr)
            assert np.array_equal(a[key].quat, b[key].quat)
    jo, to = _gate_options()
    ro = room.replay_options(True, room.reference_test_profile(
        convert.options_from_dict(dataclasses.asdict(small_options()))))
    assert ro == to
    assert (room.REPLAY_SEED, room.REPLAY_NOISE, room.REPLAY_FRAMES,
            room.REPLAY_WINDOW, room.REPLAY_PERIOD, room.REPLAY_STEPS) == \
        (47, 0.005, 15, jo.backend.window, jo.backend.period,
         jo.backend.num_steps)


@pytest.mark.parametrize("case", ["random", "empty", "far"])
def test_unique_voxels_is_the_row_unique(case):
    """The replay's packed-key unique gives ``np.unique(axis=0)``'s rows in
    its order (and falls back to it beyond +/-2^20 voxels)."""
    from ct_icp_torch.odometry.odometry import _unique_voxels
    rng = np.random.default_rng(3)
    coords = {"random": rng.integers(-300, 300, (50000, 3)),
              "empty": np.zeros((0, 3)),
              "far": rng.integers(-(1 << 22), 1 << 22, (1000, 3))}[case]
    coords = coords.astype(np.int32)
    got = _unique_voxels(coords)
    want = np.unique(coords, axis=0)
    assert got.dtype == np.int32 and np.array_equal(got, want)
