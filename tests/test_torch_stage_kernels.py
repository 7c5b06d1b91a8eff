"""The four device stages that kernels K14-K17 take over, through the port's
dispatching entry points on the CPU (their plain versions), against
ct_icp_tpu on the same inputs, and the host side of each kernel's launcher.

  * K14: ``pipeline.unpack_scan`` bit for bit on every u16 code of every
    column; ``transform_points`` and ``distort_raw`` within 1e-6 of
    1 + the point's largest coordinate (float32 rounding in another
    order), on a slerp pair, a near-parallel pair (the nlerp fallback) and
    a pair in opposite hemispheres (the sign flip);
  * K15: ``voxel_map.prune_level`` / ``prune_levels`` on a three-level
    map, gate on and off: keys, counts, flags and num_points bit for bit;
  * K16: ``ops/voxel.py::compact_mask`` bit for bit at N = capacity,
    N > capacity and an all-False mask;
  * K17: ``voxel_map.radius_describe`` (the search and
    ``compute_description`` of its lists, normal-only and full) within the
    tolerances of tests/test_torch_knn_search.py.
The launchers' layouts (grids, the levels' first blocks, the limits that
raise) are pure host code and are checked here; the kernels themselves
run on the card (tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.convert import map_state_from_numpy
from ct_icp_torch.kernels import compact_mask as k16
from ct_icp_torch.kernels import knn_search as k12
from ct_icp_torch.kernels import prune_levels as k15
from ct_icp_torch.kernels import scan_transform as k14
from ct_icp_torch.mapping import voxel_map as tvm
from ct_icp_torch.odometry import pipeline as tpl
from ct_icp_torch.ops import voxel as tvx
from ct_icp_tpu.core import se3_np as s3n
from ct_icp_tpu.mapping import voxel_map as jvm
from ct_icp_tpu.odometry import pipeline as jpl
from ct_icp_tpu.ops import voxel as jvx
from ct_icp_tpu.ops.neighborhood import compute_description as j_desc

_jit_insert = jax.jit(jvm.insert_points,
                      static_argnames=("max_dirty", "with_normals",
                                       "max_rounds"))
_jit_prune = jax.jit(jvm.prune_level)


# ------------------------------------------------------------------ K14 —
def test_unpack_scan_every_code_bit_for_bit():
    """Every u16 code in every column (0, 32767, 32768 and 65535 among
    them), each column in its own order."""
    rng = np.random.default_rng(20)
    codes = np.arange(65536, dtype=np.uint16)
    packed = np.stack([codes, rng.permutation(codes), rng.permutation(codes),
                       rng.permutation(codes)], -1)
    assert {0, 32767, 32768, 65535} <= set(packed[:, 3].tolist())
    want = jpl.unpack_scan(jnp.asarray(packed))
    got = tpl.unpack_scan(torch.from_numpy(packed.view(np.int16)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.float32 and got[0].shape == (65536, 3)


def _poses(case):
    rng = np.random.default_rng(21)
    qb = s3n.quat_from_rotvec(rng.normal(scale=0.3, size=3))
    if case == "slerp":
        qe = s3n.quat_from_rotvec(rng.normal(scale=0.3, size=3))
    elif case == "near":         # |dot| > 1 - 1e-7: the nlerp fallback
        qe = qb + np.array([2e-8, -1e-8, 0.0, 1e-8])
    else:                        # the other hemisphere: the sign flip
        qe = -s3n.quat_from_rotvec(rng.normal(scale=0.3, size=3))
    qb, qe = (q / np.linalg.norm(q) for q in (qb, qe))
    tb, te = rng.normal(size=3) * 5.0, rng.normal(size=3) * 5.0
    return [a.astype(np.float32) for a in (qb, tb, qe, te)]


@pytest.mark.parametrize("case", ["slerp", "near", "flip"])
def test_transform_and_distort_match_reference(case):
    rng = np.random.default_rng(22)
    raw = rng.uniform(-60, 60, (8192, 3)).astype(np.float32)
    alphas = rng.uniform(0, 1, 8192).astype(np.float32)
    alphas[:3] = [0.0, 1.0, 0.5]
    qb, tb, qe, te = _poses(case)
    if case == "near":
        d = abs(float(np.dot(qb.astype(np.float64), qe)))
        assert d > 1.0 - 1e-7
    args_j = [jnp.asarray(a) for a in (raw, alphas, qb, tb, qe, te)]
    args_t = [torch.from_numpy(a) for a in (raw, alphas, qb, tb, qe, te)]
    for jf, tf in ((jpl.transform_points, tpl.transform_points),
                   (jpl.distort_raw, tpl.distort_raw)):
        want = np.asarray(jf(*args_j))
        got = tf(*args_t).numpy()
        # relative to the point's scale: a coordinate near 0 is the
        # difference of terms of the point's size, rounded at that size
        scale = 1.0 + np.maximum(np.abs(want), np.abs(raw)).max(
            -1, keepdims=True)
        assert (np.abs(got - want) <= 1e-6 * scale).all()
    # the points moved: the comparison is not of identities
    assert np.abs(tpl.transform_points(*args_t).numpy() - raw).max() > 0.1


def test_scan_transform_layout():
    assert k14.grid_blocks(0) == 0
    assert k14.grid_blocks(1) == 1
    assert k14.grid_blocks(32768) == 128
    assert k14.grid_blocks(131072 + 1) == 513
    with pytest.raises(ValueError):
        k14.grid_blocks(-1)


# ------------------------------------------------------------------ K15 —
@functools.lru_cache(maxsize=None)
def _three_levels():
    """The indoor walk's three level shapes, cut to small tables: (capacity
    log2, points a voxel, resolution), each filled by the reference."""
    rng = np.random.default_rng(23)
    pts = np.concatenate([
        np.stack([rng.uniform(-25, 25, 5000), rng.uniform(-25, 25, 5000),
                  rng.normal(scale=0.05, size=5000)], -1),
        np.stack([rng.uniform(-25, 25, 3000), np.full(3000, 4.0),
                  rng.uniform(0, 3, 3000)], -1)]).astype(np.float32)
    out = []
    for cap_log2, p, res in ((12, 8, 0.5), (11, 6, 1.0), (10, 4, 3.0)):
        jl, _ = _jit_insert(jvm.make_level(cap_log2, p), jnp.asarray(pts),
                            jnp.ones(pts.shape[0], bool), res, 0.05,
                            jnp.zeros(3, jnp.float32),
                            max_dirty=pts.shape[0], with_normals=True,
                            max_rounds=12)
        out.append({k: np.array(v) for k, v in jl._asdict().items()})
    return out


def _assert_level(jl, tl, what):
    np.testing.assert_array_equal(tl.keys.numpy(),
                                  np.asarray(jl.keys).view(np.int32),
                                  err_msg=f"{what} keys")
    for name in ("count", "nflags"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(getattr(jl, name)),
                                      err_msg=f"{what} {name}")
    assert int(tl.num_points[0]) == int(jl.num_points), f"{what} num_points"


@pytest.mark.parametrize("gate", [None, True, False])
def test_prune_levels_match_reference(gate):
    fields = _three_levels()
    location, max_distance = np.array([6.0, -3.0, 1.0], np.float32), 14.0
    tls = map_state_from_numpy([dict(f) for f in fields])
    g = None if gate is None else torch.tensor(gate)
    tvm.prune_levels(tls, torch.from_numpy(location), max_distance, gate=g)
    removed = 0
    for i, f in enumerate(fields):
        jl = jvm.MapLevel(**{k: jnp.asarray(v) for k, v in f.items()})
        if gate is not False:
            jl = _jit_prune(jl, jnp.asarray(location), max_distance)
        _assert_level(jl, tls[i], f"level {i}")
        removed += int(f["num_points"]) - int(tls[i].num_points[0])
    assert (removed > 0) == (gate is not False)
    # one level at a time is the same prune
    one = map_state_from_numpy([dict(f) for f in fields])
    for lv in one:
        tvm.prune_level(lv, torch.from_numpy(location), max_distance, gate=g)
    for a, b in zip(one, tls):
        for name in ("keys", "count", "nflags", "num_points"):
            assert torch.equal(getattr(a, name), getattr(b, name))


def test_prune_levels_layout():
    first, blocks = k15.layout([1 << 20, 1 << 19, 1 << 17])
    assert first == [0, 4096, 6144] and blocks == 6656
    assert k15.layout([300]) == ([0], 2)
    assert k15.layout([1] * k15.MAX_LEVELS)[1] == k15.MAX_LEVELS
    for caps in ([], [8] * (k15.MAX_LEVELS + 1), [256, 0]):
        with pytest.raises(ValueError):
            k15.layout(caps)
    # the threshold rounds as the plain comparison rounds it
    assert k15.threshold(0.1) == float(np.float32(0.1 * 0.1))
    assert k15.threshold(np.float32(100.0)) == 10000.0


# ------------------------------------------------------------------ K16 —
@pytest.mark.parametrize("n, cap, p", [(3000, 3000, 0.4), (3000, 700, 0.5),
                                       (3000, 512, 0.0), (0, 8, 0.5),
                                       (5, 64, 1.0)])
def test_compact_mask_matches_reference(n, cap, p):
    mask = np.random.default_rng(24).uniform(size=n) < p
    wi, wc, wv = jvx.compact_mask(jnp.asarray(mask), cap)
    for ti, tc, tv in (tvx.compact_mask(torch.from_numpy(mask), cap),
                       k16.compact_mask(torch.from_numpy(mask), cap)):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
        assert int(tc) == int(wc) == min(int(mask.sum()), cap)
        assert tc.dtype == torch.int32 and tc.dim() == 0


def test_compact_mask_layout():
    assert k16.layout(0, 1056) == (0, 1)
    assert k16.layout(256, 1056) == (1, 1)
    assert k16.layout(16830, 1056) == (1, 66)
    assert k16.layout(1 << 20, 1056) == (4, 1024)
    tiles, blocks = k16.layout(1056 * 64 * 256, 1056)
    assert tiles == k16.MAX_TILES and blocks == 1056
    with pytest.raises(ValueError):
        k16.layout(1056 * 64 * 256 + 1, 1056)
    with pytest.raises(ValueError):
        k16.layout(-1, 1056)


def test_kernel_or_raise_off_the_cpu():
    """A tensor on neither the CPU nor a CUDA device has no kernel: the
    entry points raise, never fall back."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        k16.compact_mask(torch.zeros(8, dtype=torch.bool, device=meta), 4)
    with pytest.raises(ValueError, match="no kernel"):
        k14.unpack(torch.zeros((8, 4), dtype=torch.int16, device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        q = torch.zeros(4, device=meta)
        t = torch.zeros(3, device=meta)
        k14.transform(torch.zeros((8, 3), device=meta),
                      torch.zeros(8, device=meta), q, t, q, t)
    lv = tvm.make_level(4, 2, meta)
    with pytest.raises(ValueError, match="no kernel"):
        k15.prune_levels([lv], torch.zeros(3, device=meta), 1.0)


# ------------------------------------------------------------------ K17 —
@functools.lru_cache(maxsize=None)
def _knn_map(seed=25, p=20):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([
        np.stack([rng.uniform(-5, 5, 6000), rng.uniform(-5, 5, 6000),
                  rng.normal(scale=0.02, size=6000)], -1),
        np.stack([rng.uniform(-5, 5, 3000), np.full(3000, 2.0),
                  rng.uniform(0, 3, 3000)], -1),
        np.stack([rng.normal(scale=0.05, size=600) + 1.0,
                  rng.normal(scale=0.05, size=600) - 1.0,
                  rng.uniform(0, 3, 600)], -1)]).astype(np.float32)
    jl, _ = _jit_insert(jvm.make_level(12, p), jnp.asarray(pts),
                        jnp.ones(pts.shape[0], bool), 0.8, 0.05,
                        jnp.zeros(3, jnp.float32), max_dirty=pts.shape[0],
                        with_normals=False, max_rounds=16)
    q = pts[rng.choice(pts.shape[0], 300, replace=False)]
    q = (q + rng.normal(scale=0.08, size=q.shape)).astype(np.float32)
    qv = np.ones(q.shape[0], bool)
    qv[::11] = False
    return {k: np.array(v) for k, v in jl._asdict().items()}, q, qv


@pytest.mark.parametrize("full", [False, True])
def test_radius_describe_matches_reference(full):
    f, q, qv = _knn_map()
    jl = jvm.MapLevel(**{k: jnp.asarray(v) for k, v in f.items()})
    tl = map_state_from_numpy([f])[0]
    jp, jm, _ = jax.jit(functools.partial(
        jvm.radius_search, resolution=0.8, nv=1, k=20))(
            jl, jnp.asarray(q), jnp.asarray(qv), jnp.float32(0.9))
    jd = j_desc(jp, jm, jnp.asarray(q))
    nb, td = tvm.radius_describe(tl, torch.from_numpy(q),
                                 torch.from_numpy(qv), 0.9, 0.8, 1, 20,
                                 full=full)
    np.testing.assert_array_equal(nb.mask.numpy(), np.asarray(jm))
    live = np.asarray(jm).sum(1) >= 5
    assert live.mean() > 0.5
    planar = live & (np.asarray(jd.a2D) > 0.5)
    cos = np.abs((td.normal.numpy() * np.asarray(jd.normal)).sum(-1))
    assert planar.sum() > 50 and (1 - cos[planar]).max() < 1e-5
    np.testing.assert_allclose(td.a2D.numpy()[live],
                               np.asarray(jd.a2D)[live], atol=1e-3)
    if full:
        cov_w, cov_t = np.asarray(jd.covariance), td.covariance.numpy()
        scale = np.abs(cov_w).max(axis=(1, 2)) + 1e-9
        assert (np.abs(cov_t - cov_w).max(axis=(1, 2))[live]
                / scale[live]).max() < 1e-5
        np.testing.assert_allclose(td.barycenter.numpy()[live],
                                   np.asarray(jd.barycenter)[live],
                                   atol=1e-6)
        for name in ("linearity", "planarity"):
            np.testing.assert_allclose(getattr(td, name).numpy()[live],
                                       np.asarray(getattr(jd, name))[live],
                                       atol=1e-4)
        clear = live & (np.asarray(jd.eigvals)[:, 0]
                        > 1.05 * np.asarray(jd.eigvals)[:, 1])
        cos_l = np.abs((td.line.numpy() * np.asarray(jd.line)).sum(-1))
        assert clear.sum() > 20 and (1 - cos_l[clear]).max() < 1e-4


def test_knn_layout():
    assert k12.layout(27, 30, 40) == 2
    assert k12.layout(27, 30, 32) == 1
    assert k12.layout(343, 30, 128) == 4
    for n_off, p, k in ((27, 30, 0), (27, 30, k12.MAX_K + 1), (1, 4, 5)):
        with pytest.raises(ValueError):
            k12.layout(n_off, p, k)
