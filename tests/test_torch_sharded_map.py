"""The port's sharded voxel map (ct_icp_torch.parallel.sharded_map) against
ct_icp_tpu's on the CPU: gloo ranks (comm.spawn, tests/torch_dist_cases.py)
against a JAX Mesh of the same size, 1, 2 and 4.

Per shard, keys (uint32 bit patterns), counts, points, num_points and
flags are equal bit for bit, and the inserted and dropped totals equal;
normals agree within 2e-4 (an eigensolve of float32 moments, summed in
another order; the flags say which voxels were refit). The ball query's
counts are equal, its sums within 1e-4 relative (the ranks' sums added in
gloo's order, the local sums in K2's), and its closest point and distance
within 1e-5 where a query has neighbours (with none, the reference averages
every shard's argmin-over-inf row). Also here: the with_normals insert on
one level (K3's rank-0 slots, K10's refit) against the reference's
insert_points, with and without a max_dirty that cuts the dirty list.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ct_icp_torch import convert
from ct_icp_torch.config import options as topt
from ct_icp_torch.kernels import owner_pack as k11
from ct_icp_torch.mapping import voxel_map as tvm
from ct_icp_torch.parallel import comm
from ct_icp_tpu.config.options import (MultiResolutionVoxelMapOptions,
                                       ResolutionParam)
from ct_icp_tpu.mapping import voxel_map as vm
from ct_icp_tpu.parallel import sharded_map as sm

RANKS = (1, 2, 4)
NORMAL_TOL = 2e-4
# tests/test_sharded_map.py's map, and its two-level one
OPTS = MultiResolutionVoxelMapOptions(
    resolutions=(ResolutionParam(0.8, 0.0, 30, 15),), default_radius=0.75)
OPTS2 = MultiResolutionVoxelMapOptions(
    resolutions=(ResolutionParam(0.4, 0.0, 20, 14),
                 ResolutionParam(1.2, 0.0, 30, 13)), default_radius=0.75)
Z3 = np.zeros(3, np.float32)
BEGIN = np.array([0.5, -1.0, 0.2], np.float32)


def _port_options(o):
    return convert.options_from_dict(dataclasses.asdict(o),
                                     topt.MultiResolutionVoxelMapOptions)


def _scene(rng, n):
    """A floor and two walls (the graft entry's geometry) with noise:
    voxels of many points, whose normals the insert refits."""
    g = np.zeros((n, 3), np.float32)
    h = n // 2
    g[:h, :2] = rng.uniform(-6, 6, (h, 2))
    g[h:, 0] = rng.uniform(-6, 6, n - h)
    g[h:, 2] = rng.uniform(0, 3, n - h)
    g[h:, 1] = np.where(rng.uniform(size=n - h) < 0.5, -4.0, 4.0)
    return (g + rng.normal(scale=0.02, size=g.shape)).astype(np.float32)


def _cases():
    """tests/test_sharded_map.py's cases on the scene: two inserts of a
    frame each (a voxel gains at most 4 points an insert, so the second
    refits the voxels the first began)."""
    rng = np.random.default_rng(1)
    pts = [_scene(rng, 4000), _scene(rng, 4000)]
    near = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    far = rng.uniform(60, 80, (500, 3)).astype(np.float32)
    over = np.zeros((2048, 3), np.float32)
    over[:, 0] = rng.uniform(0.0, 1.5, 2048)       # two 0.8 m voxels
    multi = [_scene(rng, 2400), _scene(rng, 2400)]
    ones = np.ones(4000, bool)

    def twice(mode, frames, max_dirty):
        return [(mode, f, ones[:len(f)], BEGIN, Z3, 1e9, max_dirty, 2.0)
                for f in frames]

    return {
        "broadcast": dict(options=OPTS,
                          updates=twice("broadcast", pts, 1 << 13),
                          queries=[(0, 1, pts[1][:128], 0.75)]),
        "partitioned": dict(options=OPTS,
                            updates=twice("partitioned", pts, 1 << 13)),
        "overflow": dict(options=OPTS, updates=[
            ("partitioned", over, ones[:2048], Z3, Z3, 1e9, 1 << 12, 1.0)]),
        "multi_broadcast": dict(options=OPTS2, updates=twice(
            "broadcast", multi, 1 << 12)),
        "multi_partitioned": dict(options=OPTS2, updates=twice(
            "partitioned", multi, 1 << 12)),
        "prune": dict(options=OPTS, updates=[
            ("broadcast", np.concatenate([near, far]), ones[:1000], Z3, Z3,
             1e9, 1 << 12, 2.0),
            ("broadcast", near[:1], np.zeros(1, bool), Z3, Z3, 30.0,
             1 << 12, 2.0)]),
    }


def _reference(n, cases):
    mesh = Mesh(np.array(jax.devices()[:n]), ("map",))
    fns = {}      # one jitted update a configuration: fewer compiles
    out = {}
    for name, case in cases.items():
        state = sm.make_sharded_map(mesh, case["options"])
        counts = []
        for (mode, world, valid, begin_tr, location, max_distance,
             max_dirty, slack) in case["updates"]:
            key = (id(case["options"]), mode, max_dirty, slack)
            if key not in fns:
                fns[key] = sm.make_partitioned_update_fn(
                    mesh, case["options"], max_dirty, slack=slack) \
                    if mode == "partitioned" else sm.make_sharded_update_fn(
                        mesh, case["options"], max_dirty)
            res = fns[key](state, jnp.asarray(world), jnp.asarray(valid),
                      jnp.asarray(begin_tr), jnp.asarray(location),
                      jnp.float32(max_distance))
            state = res[0]
            counts.append([int(x) for x in res[1:]])
        queries = []
        for level, nv, q, radius in case.get("queries", ()):
            fn = sm.make_sharded_ball_query_fn(mesh, case["options"], level,
                                               nv)
            queries.append([np.asarray(x) for x in fn(
                state, jnp.asarray(q), jnp.ones(len(q), bool), radius)])
        out[name] = {"levels": [{f: np.asarray(getattr(lvl, f))
                                 for f in lvl._fields}
                                for lvl in state.levels],
                     "counts": counts, "queries": queries}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{n: (the port's per-rank results, the reference's)}, one spawn and
    one mesh a size."""
    cases = _cases()
    port_cases = {k: dict(v, options=_port_options(v["options"]))
                  for k, v in cases.items()}
    d = tmp_path_factory.mktemp("store")
    return {n: (comm.spawn("torch_dist_cases:sharded_map_cases", n, d,
                           args=(port_cases,)), _reference(n, cases))
            for n in RANKS}


def _check_shards(port, ref, n):
    """Every level's shard of every rank against the reference's."""
    for li, rlvl in enumerate(ref):
        for r in range(n):
            p = port[r][li]
            np.testing.assert_array_equal(p["keys"],
                                          rlvl["keys"][r].astype(np.uint32))
            for f in ("count", "points", "nflags"):
                np.testing.assert_array_equal(p[f], rlvl[f][r], err_msg=f)
            assert int(p["num_points"]) == int(np.asarray(
                rlvl["num_points"][r]).reshape(()))
            np.testing.assert_allclose(p["normals"], rlvl["normals"][r],
                                       atol=NORMAL_TOL)


def _levels(port_ranks, case):
    return [rank[case]["levels"] for rank in port_ranks]


def test_owner_hash_matches_reference():
    rng = np.random.default_rng(0)
    coords = rng.integers(-2 ** 31, 2 ** 31 - 1, (4096, 3),
                          dtype=np.int64).astype(np.int32)
    coords[:8] = [[0, 0, 0], [-1, -1, -1], [-1, 0, 1], [1, -1, 0],
                  [-(2 ** 31), 2 ** 31 - 1, -5], [7, -3, -200],
                  [-100, -100, 100], [3, 3, -3]]
    ref = np.asarray(sm.owner_hash(jnp.asarray(coords))).astype(np.int64)
    port = k11.owner_hash(torch.as_tensor(coords)).numpy()
    np.testing.assert_array_equal(port, ref)
    for n in (2, 3, 4, 8):
        np.testing.assert_array_equal(port % n, (ref % n))


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", ["broadcast", "partitioned",
                                  "multi_broadcast", "multi_partitioned"])
def test_insert_matches_reference(runs, n, case):
    port, ref = runs[n]
    assert all(p[case]["counts"] == ref[case]["counts"] for p in port)
    _check_shards(_levels(port, case), ref[case]["levels"], n)
    # the refit normals exist: voxels of >= 5 points carry flag 2
    assert sum(int((lv[0]["nflags"] == 2).sum())
               for lv in _levels(port, case)) > 50


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("multi", [False, True])
def test_partitioned_equals_broadcast(runs, n, multi):
    port, _ = runs[n]
    b, p = ("multi_broadcast", "multi_partitioned") if multi else \
        ("broadcast", "partitioned")
    assert [c[1] for c in port[0][p]["counts"]] == [0, 0]
    assert [c[0] for c in port[0][p]["counts"]] == \
        [c[0] for c in port[0][b]["counts"]]
    for r in range(n):
        for lb, lp in zip(port[r][b]["levels"], port[r][p]["levels"]):
            for f in ("keys", "count", "points", "nflags", "num_points"):
                np.testing.assert_array_equal(lb[f], lp[f])


@pytest.mark.parametrize("n", RANKS)
def test_overflow_drops_reference_count(runs, n):
    port, ref = runs[n]
    (inserted, dropped), = ref["overflow"]["counts"]
    assert port[0]["overflow"]["counts"] == [[inserted, dropped]]
    assert dropped > 0 or n == 1
    _check_shards(_levels(port, "overflow"), ref["overflow"]["levels"], n)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_prune_matches_reference(runs, n):
    port, ref = runs[n]
    assert port[0]["prune"]["counts"] == ref["prune"]["counts"]
    _check_shards(_levels(port, "prune"), ref["prune"]["levels"], n)
    total = sum(int(lv[0]["count"].sum()) for lv in _levels(port, "prune"))
    assert ref["prune"]["counts"][0][0] == 1000
    assert total == ref["prune"]["counts"][0][0] - 500


@pytest.mark.parametrize("n", RANKS)
def test_ball_query_matches_reference(runs, n):
    port, ref = runs[n]
    count, sum_rel, sum_outer, closest, dist = ref["broadcast"]["queries"][0]
    for rank in port:
        pc, pr, po, pcl, pd = rank["broadcast"]["queries"][0]
        np.testing.assert_array_equal(pc, count)
        scale = np.maximum(np.abs(sum_outer).max(), 1.0)
        np.testing.assert_allclose(pr, sum_rel, atol=1e-4 * scale)
        np.testing.assert_allclose(po, sum_outer, atol=1e-4 * scale)
        has = count > 0
        assert has.sum() > 64
        np.testing.assert_allclose(pcl[has], closest[has], atol=1e-5)
        np.testing.assert_allclose(pd[has], dist[has], atol=1e-5)
        assert np.isinf(pd[~has]).all()


@pytest.mark.parametrize("max_dirty", [1 << 12, 40])
def test_with_normals_insert_matches_reference(max_dirty):
    """Two inserts into one level (the second refits voxels the first
    filled); a max_dirty of 40 cuts each insert's dirty list."""
    rng = np.random.default_rng(7)
    frames = [_scene(rng, 3000), _scene(rng, 3000)]
    begin = jnp.asarray(BEGIN)
    ref = vm.make_level(14, 20)
    port = tvm.make_level(14, 20, "cpu")
    for pts in frames:
        ref, n_ref = vm.insert_points(ref, jnp.asarray(pts),
                                      jnp.ones(len(pts), bool), 0.5, 0.05,
                                      begin, max_dirty)
        n_port = tvm.insert_points(port, torch.as_tensor(pts),
                                   torch.ones(len(pts), dtype=torch.bool),
                                   0.5, 0.05, 4, torch.as_tensor(BEGIN),
                                   max_dirty)
        assert int(n_port) == int(n_ref)
    p, = convert.map_state_to_numpy([port])
    for f in ("keys", "count", "points", "nflags"):
        np.testing.assert_array_equal(p[f], np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_allclose(p["normals"], np.asarray(ref.normals),
                               atol=NORMAL_TOL)
    refit = int((p["nflags"] == 2).sum())
    assert (refit <= 2 * 40) if max_dirty == 40 else refit > 200
