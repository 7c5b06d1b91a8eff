"""The map export of the port (``voxel_map.recompute_level_normals`` and
``refit_normals``, kernel K10 ``level_normals`` on the CPU through its
plain version, and ``Odometry.get_map_points``) against ct_icp_tpu's, on
every level of the
three-level room map of tests/test_torch_replay.py, four frames of 40,000
points (converted from the reference's).

* ``recompute_level_normals``: the flags and the set of refit slots bit for
  bit; the normals by component within 1e-4 where the two smallest
  eigenvalues of the voxel's covariance are apart (a gap over 5 % of the
  largest: where they meet, the smallest one's eigenvector is not defined
  and float32 sums taken in another order turn it freely), and by sign too
  where the orientation is decided (|(barycenter - location) . normal| over
  1e-3 m); every other slot's normal bit for bit. The voxels the rule
  leaves out are counted and must stay few.
* ``refit_normals`` on a list of slots: each row the whole level's refit
  of its slot, bit for bit.
* ``get_map_points``: the points (float64, the origin added) bit for bit in
  the reference's order (slot, then point), the normals as above, point by
  point.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ct_icp_torch import convert
from ct_icp_torch.core import pose as tpose
from ct_icp_torch.kernels import level_normals as k10
from ct_icp_torch.mapping import voxel_map as tvm
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.core import pose as jpose
from ct_icp_tpu.mapping import voxel_map as jvm

from test_odometry import small_options
from test_torch_replay import _frame, _port_of, build_room_maps
from test_torch_replay import single_torch_thread  # noqa: F401

# the room map at a density where most voxels of every level hold >= 5
# points: four frames of 40,000 points, at capacities that hold them
DENSE_MAP = jopt.MultiResolutionVoxelMapOptions(
    resolutions=(jopt.ResolutionParam(0.2, 0.03, 30, 18),
                 jopt.ResolutionParam(0.5, 0.1, 25, 16),
                 jopt.ResolutionParam(1.5, 0.15, 25, 14)),
    default_radius=0.8)
NORMAL_ATOL = 1e-4
EIG_GAP = 5e-2          # (l_mid - l_min) / l_max below it: left out
ORIENT_MARGIN_M = 1e-3  # |(barycenter - location) . normal| below it
LEFT_OUT_MAX = 0.05     # share of the refit voxels the rule may leave out


@pytest.fixture(scope="module")
def room_map():
    opts = dataclasses.replace(small_options(), map_options=DENSE_MAP)
    return build_room_maps(points=40000, options=opts)


def _judged(level, location):
    """Per slot of a reference level (numpy fields): (refit, eigenvalues
    apart, orientation decided) in float64."""
    keys = np.asarray(level["keys"]).astype(np.uint32)
    count = np.asarray(level["count"])
    p = np.asarray(level["points"]).shape[1] // 3
    refit = (keys > 1) & (count >= 5)
    apart = np.zeros_like(refit)
    decided = np.zeros_like(refit)
    rows = np.asarray(level["points"], np.float64)
    for s in np.nonzero(refit)[0]:
        n = min(count[s], p)
        pts = np.stack([rows[s, 0:n], rows[s, p:p + n],
                        rows[s, 2 * p:2 * p + n]], -1)
        cov = np.cov(pts.T, bias=True)
        w, v = np.linalg.eigh(cov)              # ascending
        apart[s] = (w[1] - w[0]) > EIG_GAP * max(w[2], 1e-30)
        dot = (pts.mean(0) - location) @ v[:, 0]
        decided[s] = abs(dot) > ORIENT_MARGIN_M
    return refit, apart, decided


def _assert_normals(jn, tn, refit, apart, decided):
    """Normals per row: exact where not refit, within NORMAL_ATOL (with
    sign where decided, up to sign where not) where the eigenvalues are
    apart."""
    assert np.array_equal(tn[~refit], jn[~refit])
    sel = refit & apart
    d = np.abs(tn - jn).max(-1)
    flipped = np.abs(tn + jn).max(-1)
    assert np.all(d[sel & decided] < NORMAL_ATOL)
    assert np.all(np.minimum(d, flipped)[sel & ~decided] < NORMAL_ATOL)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_recompute_level_normals_matches_reference(room_map, level):
    frames, odos = room_map
    jl = odos["origin"].map_state.levels[level]
    loc = np.asarray(frames[3]["end_pose"].tr, np.float32)
    jr = jvm.recompute_level_normals(jl, loc)
    tl = convert.map_state_from_numpy([jl])[0]
    tr = tvm.recompute_level_normals(tl, torch.as_tensor(loc))
    assert tr.normals is not tl.normals
    # the level itself is left alone
    assert np.array_equal(tl.nflags.numpy(), np.asarray(jl.nflags))
    assert np.array_equal(tl.normals.numpy(), np.asarray(jl.normals))
    got = convert.map_state_to_numpy([tr])[0]
    ref = {f: np.asarray(getattr(jr, f)) for f in ("keys", "count",
                                                   "points", "normals",
                                                   "nflags")}
    refit, apart, decided = _judged(ref, loc.astype(np.float64))
    assert np.array_equal(got["nflags"], ref["nflags"])
    assert np.array_equal(k10.refit_mask(tl.keys, tl.count).numpy(), refit)
    assert np.array_equal(got["nflags"] == 2, refit)
    assert refit.sum() > 50
    left_out = int((refit & ~apart).sum())
    print(f"level {level}: {int(refit.sum())} refit voxels, {left_out} "
          f"left out (eigenvalues within {EIG_GAP:g} of the largest), "
          f"{int((refit & apart & ~decided).sum())} compared up to sign")
    assert left_out <= LEFT_OUT_MAX * refit.sum()
    _assert_normals(ref["normals"], got["normals"], refit, apart, decided)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_refit_normals_of_listed_slots(room_map, level):
    """``refit_normals`` on a list of slots in any order (occupied, empty
    and repeated ones): each row is the whole level's refit of its slot,
    bit for bit, and the level is left alone."""
    frames, odos = room_map
    jl = odos["origin"].map_state.levels[level]
    loc = torch.as_tensor(np.asarray(frames[3]["end_pose"].tr, np.float32))
    tl = convert.map_state_from_numpy([jl])[0]
    whole = tvm.recompute_level_normals(tl, loc)
    occupied = tvm.occupied_slots(tl)
    assert occupied.dtype == torch.int32 and occupied.numel() > 50
    assert torch.all(tl.count[occupied.long()] > 0)
    rng = np.random.default_rng(level)
    empty = np.nonzero(tl.keys.numpy() == 0)[0][:20]
    slots = np.concatenate([occupied.numpy(), empty, occupied.numpy()[:7]])
    slots = torch.as_tensor(slots[rng.permutation(slots.shape[0])],
                            dtype=torch.int32)
    normals, nflags = tvm.refit_normals(tl, loc, slots)
    assert torch.equal(normals, whole.normals[slots.long()])
    assert torch.equal(nflags, whole.nflags[slots.long()])
    assert np.array_equal(tl.normals.numpy(), np.asarray(jl.normals))


@pytest.mark.parametrize("level", [0, 1, 2])
def test_get_map_points_matches_reference(room_map, level):
    frames, odos = room_map
    jodo = odos["offset"]
    todo = _port_of(jodo)
    jodo.trajectory = [_frame(jpose, frames[3], 3)]
    todo.trajectory = [_frame(tpose, frames[3], 3)]
    try:
        jp = jodo.get_map_points(level)
    finally:
        jodo.trajectory = []
    tp = todo.get_map_points(level)
    assert tp.dtype == np.float64 and tp.shape == jp.shape
    assert tp.shape[0] == int(todo.map_state[level].num_points[0]) > 0
    tpts, tnrm = convert.map_points_to_numpy(tp)
    jpts, jnrm = convert.map_points_to_numpy(jp)
    assert np.array_equal(tpts, jpts)
    # each point's voxel, in the export's order
    jl = jodo.map_state.levels[level]
    lv = {f: np.asarray(getattr(jl, f)) for f in ("keys", "count", "points")}
    loc = (frames[3]["end_pose"].tr - jodo.origin).astype(np.float32)
    refit, apart, decided = _judged(lv, loc.astype(np.float64))
    occupied = (lv["keys"].astype(np.uint32) > 1) & (lv["count"] > 0)
    reps = np.where(occupied, lv["count"], 0)
    per_point = [np.repeat(m, reps) for m in (refit, apart, decided)]
    _assert_normals(jnrm, tnrm, *per_point)
    assert np.all(np.abs(np.linalg.norm(tnrm[per_point[0]], axis=1) - 1)
                  < 1e-5)
