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

