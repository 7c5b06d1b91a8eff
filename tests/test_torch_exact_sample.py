"""The exact samplers of ct_icp_torch (K13's plain version on the CPU)
against ct_icp_tpu's lexsort samplers, and the random keypoint cap against
ct_icp_tpu's given the same scores.

Tolerance: none. Indices, validity masks and counts are bit-identical: the
keys come from the same IEEE divisions and truncations, and a point's range
from the same float32 operations as the JAX package's ``jnp.linalg.norm``
runs on the CPU (two FMAs and a correctly rounded root); the ranks are
integer counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.config.options import AdaptiveGridSamplingOptions
from ct_icp_torch.kernels import exact_sample as k13
from ct_icp_torch.kernels import grid_sample as k4
from ct_icp_torch.ops import sampling as tsmp
from ct_icp_torch.ops import voxel as tvx
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.ops import sampling as jsmp


def _scan(n=4096, seed=0, invalid=0.1):
    """A LiDAR-like cloud: directions on the sphere at ranges from 0.2 m
    to 60 m, clustered so that voxels hold several points, with a share of
    invalid rows."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = np.exp(rng.uniform(np.log(0.2), np.log(60.0), n))
    pts = (u * r[:, None]).astype(np.float32)
    # repeat a third of the points with a small jitter: crowded voxels
    m = n // 3
    src = rng.integers(0, n, m)
    pts[:m] = pts[src] + rng.normal(0, 0.01, (m, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > invalid
    return pts, valid


def _same(got, want):
    for a, b, name in zip(got, want, ("idx", "out_valid", "count")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _torch(pts, valid):
    return torch.from_numpy(pts), torch.from_numpy(valid)


@pytest.mark.parametrize("voxel,capacity", [(0.5, 4096), (0.2, 4096),
                                            (1.0, 300)])
def test_exact_matches_reference(voxel, capacity):
    pts, valid = _scan()
    want = jsmp.voxel_subsample_indices_exact(jnp.asarray(pts),
                                              jnp.asarray(valid),
                                              jnp.float32(voxel), capacity)
    got = tsmp.voxel_subsample_indices_exact(*_torch(pts, valid), voxel,
                                             capacity)
    _same(got, want)
    assert 0 < int(got[2]) <= capacity


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("capacity", [4096, 700])
def test_k_sampler_matches_reference(k, capacity):
    pts, valid = _scan(seed=1)
    want = jsmp.voxel_sample_k_indices(jnp.asarray(pts), jnp.asarray(valid),
                                       jnp.float32(0.5), capacity, k)
    got = tsmp.voxel_sample_k_indices(*_torch(pts, valid), 0.5, capacity, k)
    _same(got, want)
    if capacity == 4096:
        # more points kept as k grows, never more than the valid ones
        assert int(got[2]) < int(valid.sum())


@pytest.mark.parametrize("kw", [
    {}, {"num_points_per_voxel": 2}, {"max_num_points": 500},
    {"num_points_per_voxel": 3, "max_num_points": 900}])
@pytest.mark.parametrize("capacity", [4096, 256])
def test_adaptive_matches_reference(kw, capacity):
    pts, valid = _scan(seed=2)
    jo = jopt.AdaptiveGridSamplingOptions(**kw)
    to = AdaptiveGridSamplingOptions(**kw)
    want = jsmp.adaptive_grid_sampling_indices(
        jnp.asarray(pts), jnp.asarray(valid), jo, capacity)
    got = tsmp.adaptive_grid_sampling_indices(*_torch(pts, valid), to,
                                              capacity)
    _same(got, want)
    assert int(got[2]) > 0


def test_distinct_voxels_that_collide_do_not_merge():
    """Points at the centres of distinct voxels whose reference hashes
    collide modulo a 2^8-slot table: K4's election (the hash table) merges
    them, the exact samplers keep one point a voxel."""
    rng = np.random.default_rng(3)
    coords = np.unique(rng.integers(-40, 40, (3000, 3)), axis=0)[:1500]
    h = tvx.voxel_hash_u32(torch.from_numpy(coords.astype(np.int32))) & 255
    assert len(np.unique(h.numpy())) < coords.shape[0]   # collisions
    pts = ((coords + 0.5) * 0.5).astype(np.float32)
    # each voxel twice, the second copy later in the scan
    pts = np.concatenate([pts, pts + np.float32(0.01)])
    valid = np.ones(pts.shape[0], bool)
    tp, tv = _torch(pts, valid)
    got = tsmp.voxel_subsample_indices_exact(tp, tv, 0.5, 4096)
    want = jsmp.voxel_subsample_indices_exact(jnp.asarray(pts),
                                              jnp.asarray(valid),
                                              jnp.float32(0.5), 4096)
    _same(got, want)
    assert int(got[2]) == coords.shape[0]
    np.testing.assert_array_equal(got[0][:coords.shape[0]].numpy(),
                                  np.arange(coords.shape[0]))
    merged = k4.grid_sample_plain(tp, tv, 0.5, 4096, table_log2=8)
    assert int(merged[2]) < coords.shape[0]
    two = tsmp.voxel_sample_k_indices(tp, tv, 0.5, 4096, 2)
    assert int(two[2]) == pts.shape[0]


def test_points_on_the_band_edges():
    """Points at ranges exactly 0.5, 2, 4, 8, 16 and 200 m (on the axes and
    on 3-4-5 triangles), and one float32 step either side of each: the
    band is the last edge below the range, the first edge is in range and
    the last is out."""
    edges = [0.5, 2.0, 4.0, 8.0, 16.0, 200.0]
    rows = []
    for e in edges:
        for r in (np.float32(e), np.nextafter(np.float32(e), np.float32(0)),
                  np.nextafter(np.float32(e), np.float32(1e9))):
            for axis in range(3):
                for sign in (1.0, -1.0):
                    p = np.zeros(3, np.float32)
                    p[axis] = sign * r
                    rows.append(p)
        rows.append(np.array([0.6 * e, 0.8 * e, 0.0], np.float32))
        rows.append(np.array([0.0, -0.8 * e, 0.6 * e], np.float32))
    pts = np.stack(rows).astype(np.float32)
    valid = np.ones(pts.shape[0], bool)
    jo, to = jopt.AdaptiveGridSamplingOptions(), AdaptiveGridSamplingOptions()
    for k in (1, 2):
        jo2 = dataclasses.replace(jo, num_points_per_voxel=k)
        to2 = dataclasses.replace(to, num_points_per_voxel=k)
        want = jsmp.adaptive_grid_sampling_indices(
            jnp.asarray(pts), jnp.asarray(valid), jo2, 256)
        got = tsmp.adaptive_grid_sampling_indices(*_torch(pts, valid), to2,
                                                  256)
        _same(got, want)
    keys, ok = k13.sample_keys(torch.from_numpy(pts), torch.from_numpy(valid),
                               bands=to.distance_voxel_size)
    d = np.linalg.norm(pts.astype(np.float64), axis=1)
    # on the axes the range is exact: the first edge in, the last out
    on_axis = np.count_nonzero(pts, axis=1) == 1
    assert ok.numpy()[on_axis & (d == 0.5)].all()
    assert not ok.numpy()[on_axis & (d == 200.0)].any()
    assert (keys[:, 0].numpy()[on_axis & (d == 2.0)] == 0).all()


@pytest.mark.parametrize("seed", [0, 7])
def test_random_cap_matches_reference_given_its_scores(seed):
    """The cap ranks by the scores: fed JAX's uniform draw for the same
    key (with ties planted and invalid rows), both packages keep the same
    entries in the same order."""
    n, cap, keep = 1024, 1024, 300
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=n) > 0.2
    key = jax.random.PRNGKey(seed)
    scores = np.array(jax.random.uniform(key, (n,)))
    tied = rng.integers(0, n, 200)
    scores[tied] = scores[tied[0]]
    # ct_icp_tpu's function, unjitted, with its draw replaced by these
    # scores for this call only
    real = jax.random.uniform
    jax.random.uniform = lambda k, shape: jnp.asarray(scores)
    try:
        want = jsmp.random_cap_indices.__wrapped__(jnp.asarray(valid), key,
                                                   cap, keep)
    finally:
        jax.random.uniform = real
    got = tsmp.random_cap_indices(torch.from_numpy(valid),
                                  torch.from_numpy(scores), cap, keep)
    _same(got, want)
    assert int(got[2]) == keep
    # without ties JAX's jitted function itself, on its own draw
    want = jsmp.random_cap_indices(jnp.asarray(valid), key, cap, keep)
    got = tsmp.random_cap_indices(
        torch.from_numpy(valid),
        torch.from_numpy(np.array(jax.random.uniform(key, (n,)))), cap,
        keep)
    _same(got, want)



# ---- a model of K13's insert pass (csrc/exact_sample.cu), one point a
# thread, the threads' steps between shared-memory operations interleaved
# in a random order: whichever point reaches a free slot first claims it
# and writes its key, and the election still keeps each key's earliest
# point. Held to the plain version under 20 orders of arrival.
_MAX_K = 64          # kMaxK: rank rounds a stamp spans
_U32 = 0xFFFFFFFF


def _word(stamp, rnd, i):
    """word_of: 0xffffffff - (stamp * kMaxK + round) over the index."""
    return ((_U32 - (stamp * _MAX_K + rnd)) << 32) | i


def _key_hash(key):
    """key_hash: the band's multiple, the reference's voxel hash, then a
    32-bit finaliser, all modulo 2^32."""
    band, cx, cy, cz = (int(v) & _U32 for v in key)
    h = (band * 2654435761) & _U32
    h ^= (cx * 73856093 + cy * 19349669 + cz * 83492791) & _U32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _U32
    return h ^ (h >> 16)


class _Table:
    """The persistent table: claim words (all ones at first), keys and
    stamp words (0 at first)."""

    def __init__(self, log2):
        t = 1 << log2
        self.mask = t - 1
        self.claim = [(1 << 64) - 1] * t
        self.tkey = [None] * t
        self.tstamp = [0] * t


def _insert(tab, stamp, i, key):
    """One point's probe (the insert pass's loop), a generator that yields
    after each shared-memory step and returns (slot, owner)."""
    mine = _word(stamp, 0, i)
    at = _key_hash(key) & tab.mask
    for _ in range(tab.mask + 1):
        seen = tab.claim[at]
        yield
        if seen >> 32 != mine >> 32:
            if tab.claim[at] == seen:                    # the atomicCAS won
                tab.claim[at] = mine
                yield
                tab.tkey[at] = key
                yield
                tab.tstamp[at] = stamp                   # the release store
                return at, True
            yield
        while tab.tstamp[at] != stamp:                   # the acquire loads
            yield
        if tab.tkey[at] == key:
            return at, False
        at = (at + 1) & tab.mask
    raise AssertionError("a probe passed every slot")


def _election(tab, slot, word):
    yield
    tab.claim[slot] = min(tab.claim[slot], word)         # the atomicMin


def _model_call(tab, stamp, keys, ok, k, rng):
    """One call's insert pass, election and rank rounds on ``tab``, the
    points' steps in an order drawn from ``rng``; returns kept bool[N]."""
    n = len(ok)
    slot = [-1] * n
    owner = [False] * n
    tasks = {i: _insert(tab, stamp, i, tuple(keys[i])) for i in range(n)
             if ok[i]}
    left = {w: sum(ok[w * 32:(w + 1) * 32]) for w in range((n + 31) // 32)}
    while tasks:
        i = list(tasks)[rng.integers(len(tasks))]
        try:
            next(tasks[i])
        except StopIteration as done:
            del tasks[i]
            if not isinstance(i, int):
                continue
            slot[i], owner[i] = done.value
            w = i // 32
            left[w] -= 1
            if left[w]:
                continue
            # the warp's lanes meet at __match_any_sync: one atomicMin a
            # slot, by its lowest lane, unless that lane owns the slot
            for s in {slot[j] for j in range(w * 32, min(n, w * 32 + 32))
                      if slot[j] >= 0}:
                lead = min(j for j in range(w * 32, min(n, w * 32 + 32))
                           if slot[j] == s)
                if not owner[lead]:
                    tasks[("min", lead)] = _election(tab, s,
                                                     _word(stamp, 0, lead))
    kept = [slot[i] >= 0 and tab.claim[slot[i]] == _word(stamp, 0, i)
            for i in range(n)]
    for j in range(1, k):
        for i in rng.permutation(n):
            if slot[i] >= 0 and not kept[i]:
                tab.claim[slot[i]] = min(tab.claim[slot[i]],
                                         _word(stamp, j, int(i)))
        kept = [kept[i] or (slot[i] >= 0 and tab.claim[slot[i]]
                            == _word(stamp, j, i)) for i in range(n)]
    return np.array(kept)


@pytest.mark.parametrize("table", ["kernel", "tight"])
@pytest.mark.parametrize("order", range(20))
def test_insert_model_matches_plain_in_any_order(order, table):
    """Three calls in a row on one table (a later call meets the earlier
    calls' words; k = 1, 3 and 2, with and without bands and a cap), the
    points' steps in a random order: the kept points, hence the outputs,
    are the plain version's. ``tight``: a table of the least power of two
    above N, where probes run long and keys meet in slots."""
    rng = np.random.default_rng(100 + order)
    n = 300
    log2 = (k13.table_log2_for(n) if table == "kernel"
            else n.bit_length())
    tab = _Table(log2)
    bands = AdaptiveGridSamplingOptions().distance_voxel_size
    calls = [dict(voxel_size=0.5, k=1), dict(bands=bands, k=3),
             dict(voxel_size=0.3, k=2, max_keep=60)]
    for stamp, kw in enumerate(calls, start=1):
        pts, valid = _scan(n, seed=order * 3 + stamp, invalid=0.2)
        tp, tv = _torch(pts, valid)
        keys, ok = k13.sample_keys(tp, tv, kw.get("voxel_size"),
                                   kw.get("bands"))
        kept = _model_call(tab, stamp, keys.numpy(), ok.numpy(), kw["k"],
                           rng)
        if kw.get("max_keep", 0) > 0:
            kept &= np.cumsum(kept) <= kw["max_keep"]
        want = k13.exact_sample_plain(tp, tv, 256, **kw)
        got = tvx.compact_mask(torch.from_numpy(kept), 256)
        _same((got[0], got[2], got[1]), [w.numpy() for w in want])
        assert int(want[2]) > 0
