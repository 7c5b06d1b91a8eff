"""Parity of ct_icp_torch's voxel map with ct_icp_tpu's (CPU, plain versions
of kernels K1-K3).

Inserts and prunes into small tables (capacity 2^8..2^10) so that probe
chains longer than the 8-slot window, contested claim rounds, tombstone
reuse and both election budgets (4, 12) all occur: the table (keys, count,
points, num_points) must stay bit-identical to the reference after every
step. Lookups are identical, and the rows the port's candidate slots name
(``points[slots]``) are the reference's candidate rows bit for bit, the
robust profile's 48-of-125 compaction included; the moment rescore through
the slots gives identical counts, radii and closest points and sums within
1e-4 of each query's second-moment scale, on full neighbourhoods too and
where no candidate lies in the radius.
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


def _port_rows(tl, slots):
    """The candidate rows the port's slots name (the reference's rows)."""
    return tl.points[slots.long()].numpy()


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
        tslots, tcnt = tvm.gather_candidate_planes(
            tl, torch.from_numpy(q), torch.from_numpy(qv), res, nv,
            threshold_voxel_occupancy=occ)
        assert tslots.dtype == torch.int32
        np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(_port_rows(tl, tslots), np.asarray(jr))


@functools.partial(jax.jit, static_argnames=("fresh",))
def _jax_moments(rows, cnt_ok, q, radius, k, cached, fresh):
    return jvm.moments_from_planes(
        rows, cnt_ok, q, radius, k_nearest=k,
        cached_r_eff2=None if fresh else cached,
        use_fresh=None if fresh else jnp.asarray(False), return_r_eff2=True)


def _assert_moments_match(want, got, min_live_share=0.5):
    count, sum_rel, sum_outer, closest, cdist, r_eff2 = (
        np.asarray(x) for x in want)
    # counts, shells and the closest point come from compares of
    # identically computed d2: exact
    np.testing.assert_array_equal(got.count.numpy(), count)
    np.testing.assert_array_equal(got.r_eff2.numpy(), r_eff2)
    np.testing.assert_array_equal(got.closest.numpy(), closest)
    # sqrt: the reference's XLA sqrt and torch's differ by <= 1 ulp
    np.testing.assert_allclose(got.closest_dist.numpy(), cdist, rtol=1e-6)
    # float sums: summation order differs; rtol 1e-4 of each query's
    # second-moment scale
    scale = np.abs(sum_outer).max(axis=(1, 2))[:, None] + 1e-6
    np.testing.assert_allclose(got.sum_rel.numpy() / np.sqrt(scale),
                               sum_rel / np.sqrt(scale), atol=1e-4)
    np.testing.assert_allclose(
        got.sum_outer.numpy().reshape(-1, 9) / scale,
        sum_outer.reshape(-1, 9) / scale, atol=1e-4)
    assert (count > 5).mean() > min_live_share


def _rescore_both(jl, tl, q, qv, res, nv, radius, k_nearest,
                  max_candidates=0):
    """The reference's moments on its rows and the port's through its
    slots, at moved queries against the fresh radius, then at the queries
    against a cached one. Returns [(want, got)] and the port's slots."""
    jr, jcnt = jvm.gather_candidate_planes(
        jl, jnp.asarray(q), jnp.asarray(qv), res, nv,
        max_candidates=max_candidates)
    ts, tcnt = tvm.gather_candidate_planes(
        tl, torch.from_numpy(q), torch.from_numpy(qv), res, nv,
        max_candidates=max_candidates)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(_port_rows(tl, ts), np.asarray(jr))
    q2 = (q + 0.03).astype(np.float32)
    want = _jax_moments(jr, jcnt, jnp.asarray(q2), radius, k_nearest,
                        None, True)
    got = tvm.moments_from_planes(tl, ts, tcnt, torch.from_numpy(q2),
                                  radius, k_nearest=k_nearest)
    cached = np.asarray(want[5]) * np.float32(0.8)
    want_c = _jax_moments(jr, jcnt, jnp.asarray(q), radius, k_nearest,
                          jnp.asarray(cached), False)
    got_c = tvm.moments_from_planes(tl, ts, tcnt, torch.from_numpy(q),
                                    radius, k_nearest=k_nearest,
                                    cached_r_eff2=torch.from_numpy(cached))
    return [(want, got), (want_c, got_c)], ts


@pytest.mark.parametrize("k_nearest", [40, 10, 0])
def test_moments_from_planes_matches(k_nearest):
    jl, tl, q, qv, res = _map_and_queries()
    pairs, _ = _rescore_both(jl, tl, q, qv, res, 1, 0.75, k_nearest)
    for want, got in pairs:
        _assert_moments_match(want, got)


@pytest.mark.parametrize("max_candidates", [48, 10])
def test_robust_compaction_matches_reference(max_candidates):
    """The robust profile's search: a 0.5 m map of 40 points a voxel, nv = 2
    (125 voxels) kept to max_candidates by the reference's top_k: the
    slots name its rows (the voxels it keeps, in its order, the unusable
    ones by index) and the moments match."""
    jl, tl, q, qv, res = _map_and_queries(seed=7, cap_log2=13, p=40,
                                          res=0.5)
    pairs, ts = _rescore_both(jl, tl, q, qv, res, 2, 0.8, 20,
                              max_candidates)
    assert ts.shape == (q.shape[0], max_candidates)
    for want, got in pairs:
        _assert_moments_match(want, got, min_live_share=0.4)


def test_full_neighbourhoods_match_reference():
    """A dense block: every voxel of every query's 3x3x3 neighbourhood holds
    its full P points, so each query has 27 x P live candidates."""
    rng = np.random.default_rng(11)
    p, res = 12, 0.8
    jl = jvm.make_level(12, p)
    pts = rng.uniform(-2.4, 2.4, (30000, 3)).astype(np.float32)
    jl, _, _ = _jax_insert(jl, pts, res, 0.0, 12)
    tl = map_state_from_numpy([jl._asdict()])[0]
    q = rng.uniform(-0.7, 0.7, (64, 3)).astype(np.float32)
    qv = np.ones(q.shape[0], bool)
    for k_nearest in (500, 20):
        pairs, ts = _rescore_both(jl, tl, q, qv, res, 1, 1.5, k_nearest)
        cnt = tvm.gather_candidate_planes(
            tl, torch.from_numpy(q), torch.from_numpy(qv), res, 1)[1]
        assert (cnt == p).all(), "a neighbourhood is not full"
        for want, got in pairs:
            _assert_moments_match(want, got, min_live_share=0.99)


@pytest.mark.parametrize("max_candidates", [0, 48])
def test_closest_without_candidates_matches_reference(max_candidates):
    """No in-radius candidate: the reference's argmin over all-inf takes
    flat index 0, point 0 of candidate 0. Candidate 0 is absent for a query
    off the map (its slot 0) and present but unusable for an invalid query
    inside it (its real slot)."""
    jl, tl, q, qv, res = _map_and_queries(seed=7, cap_log2=13, p=40,
                                          res=0.5)
    q[0] = [100.0, 0.0, 0.0]                 # off the map
    q[1] = [2.3, 1.3, 1.1]                   # its corner voxel on the ground
    qv[1] = False
    pairs, ts = _rescore_both(jl, tl, q, qv, res, 2, 0.8, 20,
                              max_candidates)
    slots0 = ts[:2, 0].numpy()
    assert slots0[0] == 0 and slots0[1] != 0
    for want, got in pairs:
        _assert_moments_match(want, got, min_live_share=0.4)
        assert (got.count[:2] == 0).all()
        np.testing.assert_array_equal(
            got.closest[:2].numpy(),
            tl.points[torch.from_numpy(slots0).long()][:, [0, 40, 80]]
            .numpy())
