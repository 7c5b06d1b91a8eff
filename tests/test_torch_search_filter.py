"""Parity with ct_icp_tpu of the distance strategy's two search changes
(CPU, the plain versions of K1 and K2):

* K1's normal filter (``gather_candidate_planes`` with a sensor location,
  reference voxel_map.py:699-703): the usable counts ``cnt_ok`` bit for
  bit over voxels whose flag is 0, 1 or 2 and whose normal faces the
  sensor or away from it, over all 27 or 125 voxels and with the 48-of-125
  compaction, which the filter precedes;
* K2 with a radius a query (the reference's ``radius_arr``): counts, shell
  radii and closest points identical (compares of d2 computed the same
  way), the moment sums within K2's tolerance, 1e-4 of each query's
  second-moment scale (float sums in another order), with the k-nearest
  shell histogram and without it;
* the deferred map update of a profile whose solver reads the normals,
  the normals kept by its insert.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.config import options as topt
from ct_icp_torch.convert import (map_state_from_numpy, map_state_to_numpy,
                                  options_from_dict)
from ct_icp_torch.mapping import voxel_map as tvm
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.mapping import voxel_map as jvm

_jit_insert = jax.jit(jvm.insert_points,
                      static_argnames=("max_dirty", "with_normals",
                                       "max_rounds"))


@functools.lru_cache(maxsize=None)
def _map(res, p, seed=3):
    """A reference level of ground and wall at ``res``, with each occupied
    voxel's flag drawn from {0, 1, 2} and its normal a random unit vector
    (so both signs of (sensor - query) . normal occur), and queries."""
    rng = np.random.default_rng(seed)
    jl = jvm.make_level(12, p)
    ground = np.stack([rng.uniform(-6, 6, 8000), rng.uniform(-6, 6, 8000),
                       rng.normal(scale=0.03, size=8000)], -1)
    wall = np.stack([rng.uniform(-6, 6, 3000), np.full(3000, 2.0),
                     rng.uniform(0, 3, 3000)], -1)
    pts = np.concatenate([ground, wall]).astype(np.float32)
    jl, _ = _jit_insert(jl, jnp.asarray(pts), jnp.ones(pts.shape[0], bool),
                        res, 0.05, jnp.zeros(3, jnp.float32),
                        max_dirty=pts.shape[0], with_normals=False,
                        max_rounds=16)
    f = {k: np.array(v) for k, v in jl._asdict().items()}
    c = f["keys"].shape[0]
    f["nflags"] = rng.integers(0, 3, c).astype(np.int32)
    nrm = rng.normal(size=(c, 3))
    f["normals"] = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
                    ).astype(np.float32)
    q = pts[rng.choice(pts.shape[0], 500, replace=False)]
    q = (q + rng.normal(scale=0.1, size=q.shape)).astype(np.float32)
    qv = np.ones(q.shape[0], bool)
    qv[::11] = False
    jlevel = jvm.MapLevel(**{k: jnp.asarray(v) for k, v in f.items()})
    return jlevel, map_state_from_numpy([f])[0], q, qv


SENSOR = np.array([0.5, -1.0, 1.8], np.float32)


@pytest.mark.parametrize("nv, max_c", [(1, 0), (2, 0), (2, 48)])
def test_normal_filter_counts_bit_for_bit(nv, max_c):
    res = 0.8 if nv == 1 else 0.5
    jl, tl, q, qv = _map(res, 20)
    gather = jax.jit(functools.partial(
        jvm.gather_candidate_planes, resolution=res, nv=nv,
        use_normal_filter=True, max_candidates=max_c))
    jr, jcnt = gather(jl, jnp.asarray(q), jnp.asarray(qv),
                      sensor_location=jnp.asarray(SENSOR))
    ts, tcnt = tvm.gather_candidate_planes(
        tl, torch.from_numpy(q), torch.from_numpy(qv), res, nv,
        max_candidates=max_c, sensor_location=torch.from_numpy(SENSOR),
        use_normal_filter=True)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(tl.points[ts.long()].numpy(),
                                  np.asarray(jr))
    # the filter decided: flags 0, 1 and 2 among the found voxels, voxels
    # of flag 2 dropped and kept, and it changed counts
    _, unfiltered = tvm.gather_candidate_planes(
        tl, torch.from_numpy(q), torch.from_numpy(qv), res, nv,
        max_candidates=max_c)
    found = unfiltered > 0
    flags = tl.nflags[ts.long()]
    for flag in (0, 1, 2):
        assert (found & (flags == flag)).any()
    dropped = found & (tcnt == 0)
    assert dropped.any() and (dropped <= (flags == 2)).all()
    assert (found & (flags == 2) & (tcnt > 0)).any()


@functools.partial(jax.jit, static_argnames=("k",))
def _jax_moments(rows, cnt_ok, q, radius, k):
    return jvm.moments_from_planes(rows, cnt_ok, q, radius, k_nearest=k,
                                   return_r_eff2=True)


@pytest.mark.parametrize("k_nearest", [None, 20])
def test_moments_with_a_radius_a_query(k_nearest):
    res = 0.5
    jl, tl, q, qv = _map(res, 40, seed=4)
    rng = np.random.default_rng(9)
    radius = rng.uniform(0.3, 1.5, q.shape[0]).astype(np.float32)
    jr, jcnt = jvm.gather_candidate_planes(jl, jnp.asarray(q),
                                           jnp.asarray(qv), res, 3,
                                           max_candidates=48)
    ts, tcnt = tvm.gather_candidate_planes(
        tl, torch.from_numpy(q), torch.from_numpy(qv), res, 3,
        max_candidates=48)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    q2 = (q + 0.02).astype(np.float32)
    want = _jax_moments(jr, jcnt, jnp.asarray(q2), jnp.asarray(radius),
                        k_nearest)
    got = tvm.moments_from_planes(tl, ts, tcnt, torch.from_numpy(q2),
                                  torch.from_numpy(radius),
                                  k_nearest=k_nearest)
    count, sum_rel, sum_outer, closest, cdist, r_eff2 = (
        np.asarray(x) for x in want)
    np.testing.assert_array_equal(got.count.numpy(), count)
    np.testing.assert_array_equal(got.r_eff2.numpy(), r_eff2)
    np.testing.assert_array_equal(got.closest.numpy()[count > 0],
                                  closest[count > 0])
    scale = np.abs(sum_outer).max(axis=(1, 2))[:, None] + 1e-6
    np.testing.assert_allclose(got.sum_rel.numpy() / np.sqrt(scale),
                               sum_rel / np.sqrt(scale), atol=1e-4)
    np.testing.assert_allclose(got.sum_outer.numpy().reshape(-1, 9) / scale,
                               sum_outer.reshape(-1, 9) / scale, atol=1e-4)
    # the radii differ in earnest: full neighbourhoods at large radii,
    # few points at small ones; the cap cut where it applies
    assert count.max() > (k_nearest or 100) and (count[qv] < 10).any()
    if k_nearest:
        assert (r_eff2 < radius * radius).mean() > 0.3


@pytest.mark.parametrize("prune", [False, True])
def test_deferred_update_keeps_normals(prune):
    """The deferred map update of a profile whose solver reads the voxel
    normals (``pipeline.update_map(with_normals=True)``, reference
    ``_update_map_impl``): an optional prune, then the insert with each
    level's dirty voxels refit toward the frame's begin translation, on
    two levels, twice. Keys, counts, points, flags and num_points bit for
    bit, the refit normals within 2e-4 (an eigensolve of float32 moments
    summed in another order, as tests/test_torch_sharded_map.py holds the
    refit), the inserted counts equal; one host sync a level an insert."""
    from ct_icp_torch.odometry import pipeline as tpl
    from ct_icp_tpu.odometry import pipeline as jpl
    jmo = jopt.MultiResolutionVoxelMapOptions(resolutions=(
        jopt.ResolutionParam(0.5, 0.1, 20, 12),
        jopt.ResolutionParam(1.0, 0.2, 20, 11)), default_radius=0.8)
    tmo = options_from_dict(dataclasses.asdict(jmo),
                            topt.MultiResolutionVoxelMapOptions)
    rng = np.random.default_rng(17)
    jstate = jvm.make_map(jmo)
    tstate = tvm.make_map(tmo, "cpu")
    update = jpl.make_update_map_fn(jmo, 4096, with_normals=True)
    for step in range(2):
        n = 6000
        pts = np.concatenate([
            np.stack([rng.uniform(-6, 6, n), rng.uniform(-6, 6, n),
                      rng.normal(scale=0.02, size=n)], -1),
            np.stack([rng.uniform(-6, 6, n), np.full(n, 3.0),
                      rng.uniform(0, 3, n)], -1)]).astype(np.float32)
        valid = rng.uniform(size=pts.shape[0]) < 0.95
        begin = np.array([0.3 * step, -0.2, 1.5], np.float32)
        location = np.array([2.0 * step, 0.0, 1.5], np.float32)
        jstate, n_j = update(jstate, jnp.asarray(pts), jnp.asarray(valid),
                             jnp.asarray(begin), jnp.asarray(location),
                             jnp.float32(5.0), jnp.asarray(True),
                             prune=prune)
        n_t, syncs = tpl.update_map(
            tstate, tmo, torch.from_numpy(pts), torch.from_numpy(valid),
            torch.from_numpy(location), 5.0, True, prune,
            with_normals=True, begin_tr=torch.from_numpy(begin),
            max_dirty=4096)
        assert int(n_t[0]) == int(n_j) > 0 and syncs == 2
        for jl, tl in zip(jstate.levels, map_state_to_numpy(tstate)):
            for f in ("keys", "count", "points", "nflags", "num_points"):
                np.testing.assert_array_equal(
                    tl[f], np.asarray(getattr(jl, f)).reshape(tl[f].shape),
                    err_msg=f)
            np.testing.assert_allclose(tl["normals"], np.asarray(jl.normals),
                                       rtol=0, atol=2e-4)
            # 4 election rounds an insert: >= 5 points a voxel, and so a
            # refit, from the second insert on
            assert (tl["nflags"] == 2).sum() > (50 if step else -1)
