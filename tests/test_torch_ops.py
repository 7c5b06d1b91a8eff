"""Parity of ct_icp_torch's ops with ct_icp_tpu's (CPU, plain versions).

Integer and hash outputs must be bit-identical; the eigensolve and the
descriptor agree within rtol 1e-4 (float32, different op order), normals up
to sign (the point-to-plane cost squares the residual).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ct_icp_tpu.mapping import voxel_map as jvm
from ct_icp_tpu.ops import eigen3 as jeig
from ct_icp_tpu.ops import neighborhood as jnb
from ct_icp_tpu.ops import voxel as jvx
from ct_icp_torch.core import se3 as ts3
from ct_icp_tpu.core import se3 as js3
from ct_icp_torch.ops import eigen3 as teig
from ct_icp_torch.ops import neighborhood as tnb
from ct_icp_torch.ops import voxel as tvx


def _coords(rng, n):
    """Voxel coords with negatives, zeros and magnitudes whose hash products
    wrap past 2^31 and 2^32."""
    c = rng.integers(-2 ** 20, 2 ** 20, (n, 3))
    c[:8] = [[0, 0, 0], [-1, -1, -1], [1, 2, 3], [-7, 0, 5],
             [2 ** 30, -2 ** 30, 2 ** 31 - 1], [-2 ** 31, 5, -3],
             [123456, -654321, 999], [2 ** 31 - 1, 2 ** 31 - 1, -2 ** 31]]
    return c.astype(np.int32)


def test_voxel_coords_truncate_toward_zero():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-50, 50, (4096, 3)).astype(np.float32)
    pts[:6] = [[-0.79, 0.79, 0.8], [-0.8, -1.6, 1.6], [0.0, -0.0, 2.4],
               [-2.4, 100.0, -100.0], [0.7999999, -0.8000001, 1e-8],
               [-1e-8, 3.2, -3.2]]
    for v in (0.8, 0.2, 0.5, 1.5):
        want = np.asarray(jvx.voxel_coords(jnp.asarray(pts), v))
        got = tvx.voxel_coords(torch.from_numpy(pts), v).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["hash", "key"])
def test_voxel_hashes_bit_identical(fn):
    rng = np.random.default_rng(1)
    c = _coords(rng, 4096)
    if fn == "hash":
        want = np.asarray(jvx.voxel_hash_u32(jnp.asarray(c)))
        got = tvx.voxel_hash_u32(torch.from_numpy(c)).numpy()
    else:
        want = np.asarray(jvm.voxel_key_u32(jnp.asarray(c)))
        got = tvx.voxel_key_u32(torch.from_numpy(c)).numpy()
        assert (got >= 2).all()
        # the int32 bit pattern the table stores round-trips to the uint32
        pat = tvx.as_i32(torch.from_numpy(got)).numpy()
        np.testing.assert_array_equal(pat.view(np.uint32), want)
    assert want.dtype == np.uint32 and (want >= 2 ** 31).any()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_compact_mask_bit_identical():
    rng = np.random.default_rng(2)
    for n, cap, p in ((1000, 1000, 0.3), (1000, 100, 0.5), (64, 64, 0.0),
                      (64, 32, 1.0)):
        mask = rng.uniform(size=n) < p
        wi, wc, wv = jvx.compact_mask(jnp.asarray(mask), cap)
        ti, tc, tv = tvx.compact_mask(torch.from_numpy(mask), cap)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
        assert int(tc) == int(wc)
        k = int(wc)
        np.testing.assert_array_equal(ti.numpy()[:k], np.asarray(wi)[:k])


def _spd(rng, n):
    """Covariance-like symmetric matrices: planar, linear, isotropic and
    random clouds."""
    mats = []
    for i in range(n):
        pts = rng.normal(size=(30, 3)) * rng.uniform(0.01, 1.0, 3)
        if i % 4 == 0:
            pts[:, 2] *= 1e-3        # planar
        elif i % 4 == 1:
            pts[:, 1:] *= 1e-3       # linear
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        pts = pts @ rot.T
        mats.append(np.cov(pts.T))
    mats.append(np.eye(3) * 0.3)     # isotropic
    return np.asarray(mats, np.float32)


def test_eigh3x3_matches():
    a = _spd(np.random.default_rng(3), 256)
    wv, wvec = (np.asarray(x) for x in jeig.eigh3x3(jnp.asarray(a)))
    tv, tvec = (x.numpy() for x in teig.eigh3x3(torch.from_numpy(a)))
    scale = np.abs(wv).max(-1, keepdims=True)
    # Well-separated spectra: rtol 1e-4 of the spectrum's scale. A
    # near-equal eigenvalue pair puts the closed form's acos argument at
    # +-1, where float32 loses ~sqrt(eps): both packages then sit up to
    # 1.6e-4 (of the scale) from the float64 eigenvalues, so there the
    # bound is that error, not 1e-4.
    gaps = np.minimum(wv[:, 0] - wv[:, 1], wv[:, 1] - wv[:, 2]) / scale[:, 0]
    sep = gaps > 1e-2
    assert sep.sum() > 100
    np.testing.assert_allclose(tv[sep] / scale[sep], wv[sep] / scale[sep],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tv / scale, wv / scale, atol=2.5e-4)
    # eigenvectors up to sign (the line and the normal) where they are
    # defined, i.e. the spectrum is separated
    dots = np.abs(np.sum(tvec * wvec, -1))
    np.testing.assert_allclose(dots[sep][:, [0, 2]], 1.0, atol=1e-4)


def test_description_from_moments_matches():
    rng = np.random.default_rng(4)
    m = 200
    count = rng.integers(0, 40, m).astype(np.int32)
    q = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    sum_rel = np.zeros((m, 3), np.float32)
    sum_outer = np.zeros((m, 3, 3), np.float32)
    for i in range(m):
        rel = (rng.normal(size=(count[i], 3))
               * [0.4, 0.3, 0.01 if i % 2 else 0.2]).astype(np.float32)
        sum_rel[i] = rel.sum(0)
        sum_outer[i] = rel.T @ rel
    want = jnb.description_from_moments(jnp.asarray(count), jnp.asarray(sum_rel),
                                        jnp.asarray(sum_outer), jnp.asarray(q))
    got = tnb.description_from_moments(torch.from_numpy(count),
                                       torch.from_numpy(sum_rel),
                                       torch.from_numpy(sum_outer),
                                       torch.from_numpy(q))
    # a2D takes square roots of the two smallest eigenvalues; where the
    # smallest is float32 noise around 0 (<= 3 points span at most a plane;
    # the solver needs >= 10) sqrt amplifies that noise, so compare where
    # the spectrum is resolved
    ev = np.asarray(want.eigvals)
    live = (count >= 5) & (np.abs(ev[:, 2]) > 1e-5 * np.abs(ev[:, 0]))
    assert live.sum() > 150
    np.testing.assert_allclose(got.a2D.numpy()[live],
                               np.asarray(want.a2D)[live], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.barycenter.numpy(),
                               np.asarray(want.barycenter), rtol=1e-5)
    dots = np.abs(np.sum(got.normal.numpy() * np.asarray(want.normal), -1))
    planar = np.asarray(want.planarity) > 0.5
    np.testing.assert_allclose(dots[planar], 1.0, atol=1e-4)


def test_se3_torch_matches_jax():
    rng = np.random.default_rng(5)
    n = 64
    q0 = rng.normal(size=(n, 4)).astype(np.float32)
    q1 = (q0 + 0.1 * rng.normal(size=(n, 4))).astype(np.float32)
    t0 = rng.normal(size=(n, 3)).astype(np.float32)
    t1 = rng.normal(size=(n, 3)).astype(np.float32)
    a = rng.uniform(0, 1, n).astype(np.float32)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    jq0, jq1 = js3.quat_normalize(jnp.asarray(q0)), js3.quat_normalize(
        jnp.asarray(q1))
    tq0, tq1 = ts3.quat_normalize(torch.from_numpy(q0)), ts3.quat_normalize(
        torch.from_numpy(q1))
    wq, wt = js3.se3_interpolate(jq0, jnp.asarray(t0), jq1, jnp.asarray(t1),
                                 jnp.asarray(a))
    gq, gt = ts3.se3_interpolate(tq0, torch.from_numpy(t0), tq1,
                                 torch.from_numpy(t1), torch.from_numpy(a))
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-6)
    np.testing.assert_allclose(
        ts3.quat_rotate(gq, torch.from_numpy(pts)).numpy(),
        np.asarray(js3.quat_rotate(wq, jnp.asarray(pts))), atol=1e-5)
    rv = (0.3 * rng.normal(size=(n, 3))).astype(np.float32)
    rv[:4] = 0.0
    np.testing.assert_allclose(
        ts3.quat_from_rotvec(torch.from_numpy(rv)).numpy(),
        np.asarray(js3.quat_from_rotvec(jnp.asarray(rv))), atol=1e-6)
    np.testing.assert_allclose(
        ts3.angular_distance_deg(tq0, tq1).numpy(),
        np.asarray(js3.angular_distance_deg(jq0, jq1)), rtol=1e-4, atol=1e-4)
