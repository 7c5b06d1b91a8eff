"""The floating-origin map rebase: ct_icp_torch (CPU, the plain versions of
K7 rebuild_claim and K6 row_gather) against ct_icp_tpu.

``rebuild_level`` bit for bit (keys, counts, points, normals, flags,
num_points) on levels of 2^8-2^10 slots: (a) tombstones left by
``prune_level``; (b) a shift that merges rows near the origin (voxels
either side of the shift truncate to one voxel id); (c) a table above 0.9
load, where some rows find no slot in 16 probes and are dropped. Then on
two 64-slot levels built by hand (``torch_rebase_cases.py``): 20 rows on
one probe chain, of which the 4 with the largest indices are still
unresolved after 16 rounds and dropped; two rows that merge into one voxel
after the shift, of which the larger index is kept.

Then the odometry's rebases, forced mid-run with a small rebase distance on
test_torch_odometry.py's driving scene: the streamed path (batch 4) and the
per-frame ``register_frame`` path. Both packages rebase at the same frames,
the same number of times; each origin is the float64 end position of the
frame that triggered the last rebase, and the two origins agree within the
pose tolerance (the packages' poses differ by float32 sums taken in
another order, so the origins are not bit-equal); map sizes agree within
0.1 % (points and rows within ~1e-5 m of a voxel edge go either way), end
poses within 5 mm and 0.05 deg. The reference's batched streamer reports
the batch after a rebasing batch in the wrong origin; the streamed test
finishes the reference's batches against their dispatch-time origin
(``_dispatch_time_origins``), which is what the port does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.mapping import voxel_map as tvm
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_tpu.mapping import voxel_map as jvm
from ct_icp_tpu.odometry import pipeline as jpl
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry
from test_torch_odometry import _frames, _jax_options
from torch_rebase_cases import MERGE_ROWS, chain_level, merge_level
# the autouse fixture, imported so that it applies here too
from test_torch_robust import single_torch_thread  # noqa: F401

RES = 0.5


def _occupied(level):
    return int(((level.keys != 0) & (level.keys != 1)
                & (level.count > 0)).sum())


def _level(cap_log2, p, batches, seed, prune=None):
    """A port level filled by the insert with ``batches`` point sets, its
    normals and flags random, optionally pruned (tombstones)."""
    rng = np.random.default_rng(seed)
    level = tvm.make_level(cap_log2, p, "cpu")
    for pts in batches:
        t = torch.from_numpy(pts.astype(np.float32))
        tvm.insert_points(level, t, torch.ones(t.shape[0], dtype=torch.bool),
                          RES, 0.05, 12)
    if prune is not None:
        tvm.prune_level(level, torch.tensor(prune[0], dtype=torch.float32),
                        prune[1])
    c = level.capacity
    level.normals.copy_(torch.from_numpy(
        rng.standard_normal((c, 3)).astype(np.float32)))
    level.nflags.copy_(torch.from_numpy(rng.integers(0, 4, c).astype(
        np.int32)))
    return level


def _jax_level(level):
    keys = jnp.asarray(level.keys.numpy().view(np.uint32))
    count = jnp.asarray(level.count.numpy())
    return jvm.MapLevel(keys=keys, count=count,
                        points=jnp.asarray(level.points.numpy()),
                        normals=jnp.asarray(level.normals.numpy()),
                        nflags=jnp.asarray(level.nflags.numpy()),
                        win=jvm.build_window(keys, count),
                        num_points=jnp.int32(int(level.num_points[0])))


def _case(name):
    rng = np.random.default_rng({"tombstones": 0, "merge": 1,
                                 "overload": 2}[name])
    if name == "tombstones":
        pts = rng.uniform([-4, -4, -1], [6, 4, 2], (5000, 3))
        # a shift on the voxel grid that moves every point off the
        # origin's planes: each row keeps a voxel of its own
        return (_level(10, 8, [pts], 0, prune=([0.0, 0.0, 0.0], 3.5)),
                np.array([-5.0, -5.0, -1.5]))
    if name == "merge":
        # first points in x in [1, 2): voxels 2 and 3 along x both
        # truncate to voxel 0 after a shift of 1.5
        pts = rng.uniform([1.0, -2.0, -1.0], [2.0, 2.0, 1.0], (3000, 3))
        return _level(10, 6, [pts], 1), np.array([1.5, 0.0, 0.0])
    # ~240 voxels in 256 slots: batches until the load passes 0.9
    batches = [rng.uniform([-4, -4, -1], [4, 4, 1], (150, 3))
               for _ in range(12)]
    return _level(8, 4, batches, 2), np.array([0.7, 0.3, -0.2])


def _assert_rebuild_matches(level, shift, res=RES):
    """The port's rebuild_level (CPU) equals ct_icp_tpu's bit for bit;
    returns the port's level."""
    shift = np.asarray(shift, np.float32)
    jnew = jvm.rebuild_level(_jax_level(level), jnp.asarray(shift), res)
    tnew = tvm.rebuild_level(level, torch.as_tensor(shift), res)
    np.testing.assert_array_equal(tnew.keys.numpy(),
                                  np.asarray(jnew.keys).view(np.int32))
    for field in ("count", "points", "normals", "nflags"):
        np.testing.assert_array_equal(getattr(tnew, field).numpy(),
                                      np.asarray(getattr(jnew, field)))
    assert int(tnew.num_points[0]) == int(jnew.num_points)
    return tnew


@pytest.mark.parametrize("name", ["tombstones", "merge", "overload"])
def test_rebuild_level_matches_reference(name):
    level, shift = _case(name)
    before = _occupied(level)
    if name == "tombstones":
        assert int((level.keys == 1).sum()) > 20
    if name == "overload":
        assert before > 0.9 * level.capacity
    tnew = _assert_rebuild_matches(level, shift)
    after = _occupied(tnew)
    assert int((tnew.keys == 1).sum()) == 0          # tombstones cleared
    if name == "tombstones":
        assert after == before
    else:       # merged rows, rows without a slot: dropped
        assert 0 < after < before


def test_rebuild_level_drops_rows_after_16_rounds():
    level, shift, chain = chain_level()
    tnew = _assert_rebuild_matches(level, shift.numpy())
    # 16 rounds resolve 16 rows of the chain, a round the smallest index
    # left; the other 4 keep no slot, and their points are gone
    assert _occupied(tnew) == 16
    first = level.points[:, 0] - shift[0]
    assert sorted(tnew.points[tnew.count > 0][:, 0].tolist()) == \
        sorted(first[chain[:16]].tolist())
    assert int(tnew.num_points[0]) == int(level.count[chain[:16]].sum())


def test_rebuild_level_merges_two_rows():
    level, shift = merge_level()
    tnew = _assert_rebuild_matches(level, shift.numpy())
    assert int(level.keys[62]) > 1 and int(level.count[62]) == 0
    assert _occupied(level) == 12 and _occupied(tnew) == 11
    a, b = MERGE_ROWS
    # the larger row index writes the merged voxel's slot
    moved = level.points - shift.repeat_interleave(4)
    rows_equal = (tnew.points[:, None, :] == moved[None]).all(-1)
    assert int(rows_equal[:, b].sum()) == 1
    assert not bool(rows_equal[:, a].any())
    assert int(tnew.num_points[0]) == int(level.count.sum() - level.count[a])


REBASE_DISTANCE = 0.35


def _spy_rebases(odo, attr):
    """Record (frame index, end position) of the last frame whenever the
    odometry's rebase fn ``attr`` runs."""
    calls = []
    inner = getattr(odo, attr)

    def spy(*args):
        calls.append((len(odo.trajectory) - 1,
                      odo.trajectory[-1].end_pose.tr.copy()))
        return inner(*args)

    setattr(odo, attr, spy)
    return calls


def _check_runs(jodo, todo, jcalls, tcalls, jsum, tsum):
    assert [s.success for s in tsum] == [s.success for s in jsum]
    assert all(s.success for s in tsum)
    assert [s.points_added for s in tsum] == [s.points_added for s in jsum]
    # the same rebases, after the same frames
    assert [f for f, _ in tcalls] == [f for f, _ in jcalls]
    assert todo.rebases == len(jcalls) >= 2
    # the origin is the end position of the frame that last rebased
    np.testing.assert_array_equal(jodo.origin, jcalls[-1][1])
    np.testing.assert_array_equal(todo.origin, tcalls[-1][1])
    assert np.linalg.norm(todo.origin - jodo.origin) < 5e-3
    assert np.linalg.norm(todo.origin) > 2 * REBASE_DISTANCE
    # the packages' end poses differ by ~1e-5 m, and so do their shifts: a
    # point or a map row within that of a voxel edge lands on the other side
    # (the walls are tilted in the map frame, so some always are)
    assert jodo.map_size() > 1000
    assert abs(todo.map_size() - jodo.map_size()) <= 1e-3 * jodo.map_size()
    for a, b in zip(todo.get_trajectory(), jodo.get_trajectory()):
        assert a.end_pose.location_distance(b.end_pose) < 5e-3
        assert a.end_pose.angular_distance(b.end_pose) < 0.05


def _dispatch_time_origins(odo):
    """Finish each of the reference's streamed batches against the origin
    it was dispatched in. Its batched streamer (ct_icp_tpu
    odometry.py:789-797) finishes batch k after dispatching batch k + 1,
    but copies batch k + 1's origin after that finish: when batch k's
    frames rebase, batch k + 1's frames come out shifted by the rebase
    (and its rebase distances are measured from there). The port copies
    the origin at dispatch. Batch k + 1 was dispatched in the origin that
    held when batch k's finish began."""
    entry = []
    inner = odo._finish_batch

    def finish(infos, packed, origin):
        entry.append(odo.origin.copy())
        return inner(infos, packed, entry[-2] if len(entry) > 1 else origin)

    odo._finish_batch = finish


@pytest.fixture(scope="module")
def driving():
    jo = _jax_options()
    return jo, options_from_dict(dataclasses.asdict(jo)), _frames()


def test_streamed_rebase_matches_reference(driving):
    jo, to, frames = driving
    jodo = JOdometry(jo)
    jodo.rebase_distance = REBASE_DISTANCE
    # the stream rebase is made on first use: make it now, to wrap it
    jodo._stream_rebase = jpl.make_stream_rebase_fn(jodo.map_options)
    jcalls = _spy_rebases(jodo, "_stream_rebase")
    _dispatch_time_origins(jodo)
    jpreps = [jodo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i,
                                 upload=False) for i, f in enumerate(frames)]
    jsum = list(jodo.stream_frames(iter(jpreps), batch=4))
    todo = TOdometry(to, device="cpu")
    todo.rebase_distance = REBASE_DISTANCE
    tcalls = _spy_rebases(todo, "_stream_rebase")
    tpreps = [todo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
              for i, f in enumerate(frames)]
    tsum = list(todo.stream_frames(iter(tpreps), batch=4))
    _check_runs(jodo, todo, jcalls, tcalls, jsum, tsum)


def test_per_frame_rebase_matches_reference(driving):
    jo, to, frames = driving
    jodo = JOdometry(jo)
    jodo.rebase_distance = REBASE_DISTANCE
    jcalls = _spy_rebases(jodo, "_rebase")
    jsum = [jodo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
            for i, f in enumerate(frames)]
    todo = TOdometry(to, device="cpu")
    todo.rebase_distance = REBASE_DISTANCE
    tcalls = _spy_rebases(todo, "_rebase")
    tsum = [todo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
            for i, f in enumerate(frames)]
    _check_runs(jodo, todo, jcalls, tcalls, jsum, tsum)
