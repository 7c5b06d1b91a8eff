"""The port's keypoint grid election (ct_icp_torch/ops/sampling.py, kernel
K4's plain version on the CPU) against ct_icp_tpu's: bit-identical indices,
count and validity against ``voxel_subsample_indices`` (XLA scatter-min)
and against the Pallas ``dedup_compact`` run in interpret mode."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

import tools.pallas_kernels_experiment as pk
from ct_icp_torch.kernels import grid_sample as k4
from ct_icp_torch.ops import sampling as tsmp
from ct_icp_tpu.ops import sampling as jsmp
from ct_icp_tpu.ops import voxel as jvx


def _scan(rng, n):
    """A street-like scan: ground, two walls, clutter, in [-40, 40] m."""
    g = np.stack([rng.uniform(-40, 40, n), rng.uniform(-12, 12, n),
                  rng.normal(scale=0.05, size=n)], -1)
    w = np.stack([rng.uniform(-40, 40, n),
                  np.where(rng.uniform(size=n) < 0.5, -12.0, 10.0),
                  rng.uniform(0, 8, n)], -1)
    c = rng.uniform(-40, 40, (n, 3))
    return np.concatenate([g, w, c]).astype(np.float32)


@pytest.mark.parametrize("table_log2, capacity, voxel", [
    (22, 4096, 1.0),      # the robust escalation's election (1.5 m / 1.5)
    (10, 4096, 1.0),      # 1024 slots: colliding voxels merge
    (22, 700, 1.0),       # fewer slots in the output than winners
    (21, 2048, 0.5),      # the Pallas experiment's table size
])
def test_election_matches_voxel_subsample_indices(table_log2, capacity,
                                                  voxel):
    rng = np.random.default_rng(table_log2 + capacity)
    pts = _scan(rng, 4000)
    valid = np.arange(pts.shape[0]) < pts.shape[0] - 517     # invalid tail
    valid[rng.integers(0, pts.shape[0], 200)] = False        # and holes
    want = jsmp.voxel_subsample_indices(
        jnp.asarray(pts), jnp.asarray(valid), jnp.float32(voxel), capacity,
        table_log2=table_log2)
    idx, ok, cnt = tsmp.voxel_subsample_indices(
        torch.from_numpy(pts), torch.from_numpy(valid), voxel, capacity,
        table_log2)
    n = int(want[2])
    assert int(cnt) == n
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want[1]))
    assert idx.dtype == torch.int32 and ok.dtype == torch.bool
    # the election did something: merged points, and (table_log2 = 10)
    # merged distinct voxels, or capped the count
    exact = np.unique(np.trunc(pts[valid] / np.float32(voxel)), axis=0)
    assert 0 < n < valid.sum()
    if table_log2 == 10:
        assert n < min(capacity, exact.shape[0])
    if capacity == 700:
        assert n == capacity < exact.shape[0]


@pytest.mark.parametrize("n, frac, capacity", [
    (0, 1.0, 4096),           # no point
    (5000, 0.0, 4096),        # every point invalid
    (16766, 0.97, 100),       # the robust shape's N, kept far past capacity
    (1001, 0.97, 4096),       # N not a multiple of the kernel's block
    (257, 1.0, 4096)])
def test_election_edge_cases_match_voxel_subsample_indices(n, frac,
                                                           capacity):
    """The shapes the card tests hold K4 to (tests/test_torch_kernels_gpu.py)
    through the plain version, against the reference's election."""
    rng = np.random.default_rng(n + capacity)
    pts = _scan(rng, n // 3 + 1)[:n]
    valid = rng.uniform(size=n) < frac
    want = jsmp.voxel_subsample_indices(
        jnp.asarray(pts), jnp.asarray(valid), jnp.float32(1.0), capacity,
        table_log2=22)
    idx, ok, cnt = tsmp.voxel_subsample_indices(
        torch.from_numpy(pts), torch.from_numpy(valid), 1.0, capacity, 22)
    assert int(cnt) == int(want[2])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want[1]))
    if capacity == 100:
        assert int(cnt) == capacity
    if n == 0 or frac == 0.0:
        assert int(cnt) == 0 and not ok.any() and not idx.any()


@pytest.mark.parametrize("n_valid, capacity", [(1900, 1024), (4096, 1024),
                                               (3000, 4096)])
def test_election_matches_pallas_dedup_compact(monkeypatch, n_valid,
                                               capacity):
    """The Pallas kernel's configuration: a 2^table_log2 claim table, a
    valid prefix of n_valid rows, N % 1024 == 0."""
    monkeypatch.setattr(pk.pl, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))
    rng = np.random.default_rng(n_valid)
    pts = _scan(rng, 1366)[:4096]
    n, table_log2, voxel = pts.shape[0], 12, 1.0
    assert n % 1024 == 0
    h = (jvx.voxel_hash_u32(jvx.voxel_coords(jnp.asarray(pts), voxel))
         & jnp.uint32((1 << table_log2) - 1)).astype(jnp.int32)
    want_idx, want_cnt = pk.dedup_compact(h, n_valid, capacity=capacity,
                                          table_log2=table_log2)
    valid = torch.arange(n) < n_valid
    idx, ok, cnt = tsmp.voxel_subsample_indices(
        torch.from_numpy(pts), valid, voxel, capacity, table_log2)
    m = int(want_cnt)
    assert int(cnt) == m > 0
    np.testing.assert_array_equal(idx.numpy()[:m], np.asarray(want_idx)[:m])
    np.testing.assert_array_equal(ok.numpy(), np.arange(capacity) < m)
    # a first-occurrence sweep in scan order agrees with both
    seen, first = set(), []
    for i, s in enumerate(np.asarray(h)[:n_valid]):
        if s not in seen:
            seen.add(s)
            first.append(i)
    np.testing.assert_array_equal(idx.numpy()[:m], first[:capacity])


def test_election_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(_scan(rng, 500))
    valid = torch.ones(pts.shape[0], dtype=torch.bool)
    before = k4.launches
    got = k4.grid_sample(pts, valid, 1.0, 256)
    want = k4.grid_sample_plain(pts, valid, 1.0, 256)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert k4.launches == before            # no kernel launched here
    with pytest.raises(ValueError):
        k4.grid_sample(pts.to("meta"), valid.to("meta"), 1.0, 256)
