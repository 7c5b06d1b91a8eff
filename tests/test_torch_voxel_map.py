"""Parity of ct_icp_torch's voxel map with ct_icp_tpu's (CPU, plain versions
of kernels K1-K3).

Inserts and prunes into small tables (capacity 2^8..2^10) so that probe
chains longer than the 8-slot window, contested claim rounds, tombstone
reuse and both election budgets (4, 12) all occur: the table (keys, count,
points, num_points) must stay bit-identical to the reference after every
step. Lookups and candidate rows are identical; the moment rescore gives
identical counts and sums within rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_tpu.mapping import voxel_map as jvm
from ct_icp_torch.convert import map_state_from_numpy
from ct_icp_torch.mapping import voxel_map as tvm

_jit_insert = jax.jit(jvm.insert_points,
                      static_argnames=("max_dirty", "with_normals",
                                       "max_rounds"))
_jit_prune = jax.jit(jvm.prune_level)


def _jax_insert(level, pts, resolution, min_dist, max_rounds):
    valid = np.ones(pts.shape[0], bool)
    valid[::17] = False
    lvl, n = _jit_insert(level, jnp.asarray(pts), jnp.asarray(valid),
                         resolution, min_dist, jnp.zeros(3, jnp.float32),
                         max_dirty=pts.shape[0], with_normals=False,
                         max_rounds=max_rounds)
    return lvl, int(n), valid


def _assert_same(jlevel, tlevel):
    np.testing.assert_array_equal(
        tlevel.keys.numpy(), np.asarray(jlevel.keys).view(np.int32))
    np.testing.assert_array_equal(tlevel.count.numpy(),
                                  np.asarray(jlevel.count))
    np.testing.assert_array_equal(tlevel.points.numpy(),
                                  np.asarray(jlevel.points))
    assert int(tlevel.num_points[0]) == int(jlevel.num_points)


def _cluster_points(rng, n, center, spread):
    return (center + rng.normal(scale=spread, size=(n, 3))).astype(np.float32)


@pytest.mark.parametrize("cap_log2", [8, 9, 10])
def test_insert_prune_sequence_bit_identical(cap_log2):
    rng = np.random.default_rng(cap_log2)
    p = 6
    res = 1.0
    jl = jvm.make_level(cap_log2, p)
    tl = map_state_from_numpy([jl._asdict()])[0]
    load = []
    steps = [("insert", 12, np.zeros(3), 0.05),
             ("insert", 4, np.array([3.0, 0.0, 0.0]), 0.1),
             ("insert", 4, np.zeros(3), 0.1),
             ("prune", None, np.array([6.0, 0.0, 0.0]), None),
             ("insert", 12, np.array([-2.0, 0.0, 0.0]), 0.05),
             ("insert", 4, np.array([1.0, 1.0, 0.0]), 0.0)]
    for kind, rounds, center, min_dist in steps:
        if kind == "insert":
            n_vox = (1 << cap_log2) // 3
            pts = _cluster_points(rng, 6 * n_vox, center, 2.2)
            pts[:40] = pts[0] + rng.uniform(-0.4, 0.4, (40, 3))  # one voxel
            jl, n_j, valid = _jax_insert(jl, pts, res, min_dist, rounds)
            n_t = tvm.insert_points(tl, torch.from_numpy(pts),
                                    torch.from_numpy(valid), res, min_dist,
                                    max_rounds=rounds)
            assert int(n_t[0]) == n_j
        else:
            jl = _jit_prune(jl, jnp.asarray(center, jnp.float32), 4.0)
            tvm.prune_level(tl, torch.as_tensor(center, dtype=torch.float32),
                            4.0)
        _assert_same(jl, tl)
        keys = np.asarray(jl.keys)
        load.append(((keys > 1).sum(), (keys == 1).sum()))
    # the sequence reached the regimes it is meant to cover
    assert max(o for o, _ in load) > (1 << cap_log2) // 4
    assert load[3][1] > 0, "prune left no tombstones"
    assert int(np.asarray(jl.count).max()) == p


def _map_and_queries(seed=5, cap_log2=12, p=10, res=0.8, m=300):
    rng = np.random.default_rng(seed)
    jl = jvm.make_level(cap_log2, p)
    ground = np.stack([rng.uniform(-8, 8, 6000), rng.uniform(-8, 8, 6000),
                       rng.normal(scale=0.02, size=6000)], -1)
    wall = np.stack([rng.uniform(-8, 8, 3000), np.full(3000, 3.0),
                     rng.uniform(0, 4, 3000)], -1)
    pts = np.concatenate([ground, wall]).astype(np.float32)
    jl, _, _ = _jax_insert(jl, pts, res, 0.05, 12)
    q = pts[rng.choice(pts.shape[0], m, replace=False)]
    q = (q + rng.normal(scale=0.1, size=q.shape)).astype(np.float32)
    q[:5] = [[100.0, 0, 0], [-0.01, -0.01, 0.0], [0.0, 0.0, 0.0],
             [-8.0, -8.0, 0.0], [7.99, 2.9, 1.0]]
    qv = np.ones(m, bool)
    qv[::7] = False
    return jl, map_state_from_numpy([jl._asdict()])[0], q, qv, res


@pytest.mark.parametrize("nv", [1, 2])
def test_lookup_and_candidate_gather_identical(nv):
    jl, tl, q, qv, res = _map_and_queries()
    coords = np.trunc(q / np.float32(res)).astype(np.int32)
    js, jc = jvm.find_slots_with_count(jl, jnp.asarray(coords))
    ts, tc = tvm.find_slots_with_count(tl, torch.from_numpy(coords))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (np.asarray(js) >= 0).mean() > 0.8

    for occ in (1, 5):
        jr, jcnt = jvm.gather_candidate_planes(jl, jnp.asarray(q),
                                               jnp.asarray(qv), res, nv,
                                               threshold_voxel_occupancy=occ)
        tr, tcnt = tvm.gather_candidate_planes(tl, torch.from_numpy(q),
                                               torch.from_numpy(qv), res, nv,
                                               threshold_voxel_occupancy=occ)
        np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@functools.partial(jax.jit, static_argnames=("fresh",))
def _jax_moments(rows, cnt_ok, q, radius, k, cached, fresh):
    return jvm.moments_from_planes(
        rows, cnt_ok, q, radius, k_nearest=k,
        cached_r_eff2=None if fresh else cached,
        use_fresh=None if fresh else jnp.asarray(False), return_r_eff2=True)


@pytest.mark.parametrize("k_nearest", [40, 10, 0])
def test_moments_from_planes_matches(k_nearest):
    jl, tl, q, qv, res = _map_and_queries()
    radius = 0.75
    jr, jcnt = jvm.gather_candidate_planes(jl, jnp.asarray(q), jnp.asarray(qv),
                                           res, 1)
    tr, tcnt = tvm.gather_candidate_planes(tl, torch.from_numpy(q),
                                           torch.from_numpy(qv), res, 1)
    # rescore at moved queries against the fresh radius, then the cached one
    q2 = (q + 0.03).astype(np.float32)
    want = _jax_moments(jr, jcnt, jnp.asarray(q2), radius, k_nearest,
                        None, True)
    got = tvm.moments_from_planes(tr, tcnt, torch.from_numpy(q2), radius,
                                  k_nearest=k_nearest)
    cached = np.asarray(want[5]) * np.float32(0.8)
    want_c = _jax_moments(jr, jcnt, jnp.asarray(q), radius, k_nearest,
                          jnp.asarray(cached), False)
    got_c = tvm.moments_from_planes(tr, tcnt, torch.from_numpy(q), radius,
                                    k_nearest=k_nearest,
                                    cached_r_eff2=torch.from_numpy(cached))
    for w, g in ((want, got), (want_c, got_c)):
        count, sum_rel, sum_outer, closest, cdist, r_eff2 = (
            np.asarray(x) for x in w)
        # counts, shells and the closest point come from compares of
        # identically computed d2: exact
        np.testing.assert_array_equal(g.count.numpy(), count)
        np.testing.assert_array_equal(g.r_eff2.numpy(), r_eff2)
        np.testing.assert_array_equal(g.closest.numpy(), closest)
        # sqrt: the reference's XLA sqrt and torch's differ by <= 1 ulp
        np.testing.assert_allclose(g.closest_dist.numpy(), cdist, rtol=1e-6)
        # float sums: summation order differs; rtol 1e-4 of each query's
        # second-moment scale
        scale = np.abs(sum_outer).max(axis=(1, 2))[:, None] + 1e-6
        np.testing.assert_allclose(g.sum_rel.numpy() / np.sqrt(scale),
                                   sum_rel / np.sqrt(scale), atol=1e-4)
        np.testing.assert_allclose(
            g.sum_outer.numpy().reshape(-1, 9) / scale,
            sum_outer.reshape(-1, 9) / scale, atol=1e-4)
        assert (count > 5).mean() > 0.5
