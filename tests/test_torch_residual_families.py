"""The port's residual families and losses (``ct_icp_torch/icp/residuals.py``)
against ct_icp_tpu's on the same numpy inputs (CPU): each distance's
``geometric_residuals``, ``geometric_residuals_and_grad`` and
``ct_jacobian_from_world_grad``, ``prediction_consistency_residuals`` and
the five losses' IRLS weight and cost, all within 1e-5 relative to each
output's largest entry. Also: the dual-number forward mode of each family
equals ``torch.func.jacfwd``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from ct_icp_torch.config import options as topt
from ct_icp_torch.core import dual
from ct_icp_torch.core import se3 as s3
from ct_icp_torch.icp import residuals as tres
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.icp import residuals as jres
from ct_icp_tpu.icp import solver as jslv

N = 512
N_JAC = 32
DISTANCES = ["POINT_TO_PLANE", "POINT_TO_POINT", "POINT_TO_LINE",
             "POINT_TO_DISTRIBUTION"]
LOSSES = ["STANDARD", "CAUCHY", "HUBER", "TOLERANT", "TRUNCATED"]


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max(), scale)


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    world = f(rng.uniform(-10, 10, (N, 3)))
    anchors = f(world + rng.normal(scale=0.2, size=(N, 3)))
    normals = rng.normal(size=(N, 3))
    normals = f(normals / np.linalg.norm(normals, axis=1, keepdims=True))
    lines = f(rng.normal(size=(N, 3)) * rng.uniform(0.5, 2.0, (N, 1)))
    a = rng.normal(scale=0.3, size=(N, 3, 3))
    cov = np.einsum("nij,nkj->nik", a, a) + 0.05 * np.eye(3)
    cov_inv = f(np.linalg.inv(cov))
    weights = f(rng.uniform(0.1, 1.0, N))
    alphas = f(rng.uniform(0, 1, N))
    return world, anchors, normals, lines, cov_inv, weights, alphas


@pytest.mark.parametrize("distance", DISTANCES)
def test_geometric_residuals_match_reference(distance):
    arrays = _inputs()
    want = jres.geometric_residuals(getattr(jopt.IcpDistance, distance),
                                    *(jnp.asarray(a) for a in arrays[:6]))
    got = tres.geometric_residuals(getattr(topt.IcpDistance, distance),
                                   *(torch.from_numpy(a) for a in arrays[:6]))
    _close(got.numpy(), want)
    assert got.shape == ((N, 3) if distance == "POINT_TO_POINT" else (N, 1))


@pytest.mark.parametrize("distance", DISTANCES)
def test_residuals_and_grad_match_reference(distance):
    arrays = _inputs(5)
    jd, td = (getattr(jopt.IcpDistance, distance),
              getattr(topt.IcpDistance, distance))
    wr, wg = jres.geometric_residuals_and_grad(
        jd, *(jnp.asarray(a) for a in arrays[:6]))
    gr, gg = tres.geometric_residuals_and_grad(
        td, *(torch.from_numpy(a) for a in arrays[:6]))
    _close(gr.numpy(), wr)
    _close(gg.numpy(), wg)
    tb = np.asarray([0.1, -0.2, 0.05], np.float32)
    te = np.asarray([0.9, 0.3, -0.1], np.float32)
    alphas = arrays[6]
    want = jres.ct_jacobian_from_world_grad(
        wg, jnp.asarray(arrays[0]), jnp.asarray(tb), jnp.asarray(te),
        jnp.asarray(alphas))
    got = tres.ct_jacobian_from_world_grad(
        gg, torch.from_numpy(arrays[0]), torch.from_numpy(tb),
        torch.from_numpy(te), torch.from_numpy(alphas))
    _close(got.numpy(), want)
    assert got.shape[-1] == 12


@pytest.mark.parametrize("distance", DISTANCES)
def test_forward_mode_equals_jacfwd(distance):
    """d residual / d world of each family by dual numbers (what the LM
    step's plain version uses) against torch.func.jacfwd."""
    # 32 points: jacfwd builds the whole [N, R, N, 3] Jacobian
    world, anchors, normals, lines, cov_inv, weights, _ = (
        torch.from_numpy(a[:N_JAC]) for a in _inputs(7))
    d = getattr(topt.IcpDistance, distance)

    def f(w, m=s3):
        return tres.geometric_residuals(d, w, anchors, normals, lines,
                                        cov_inv, weights, m=m)

    seed = dual.Dual(world, torch.eye(3).reshape(3, 1, 3).expand(3, N_JAC,
                                                                  3))
    lin = f(seed, dual.math)
    full = jacfwd(f)(world)
    want = torch.stack([full[i, :, i, :] for i in range(N_JAC)])
    got = lin.jacobian()
    torch.testing.assert_close(lin.v, f(world))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _prior41(seed=11):
    rng = np.random.default_rng(seed)
    out = np.zeros(41, np.float32)
    out[0] = 1.0
    for base in (14, 21, 28):
        q = rng.normal(size=4) + [4.0, 0, 0, 0]
        out[base:base + 4] = q / np.linalg.norm(q)
    out[18:21], out[25:28] = rng.normal(size=3), rng.normal(size=3)
    out[32:35] = rng.normal(scale=0.5, size=3)
    out[35:41] = rng.uniform(0.5, 5.0, 6)
    return out


def test_prediction_consistency_matches_reference():
    prior = _prior41()
    rng = np.random.default_rng(13)
    qb, qe = (np.asarray(q / np.linalg.norm(q), np.float32) for q in
              (rng.normal(size=4) + [3.0, 0, 0, 0],
               rng.normal(size=4) + [3.0, 0, 0, 0]))
    tb, te = (np.asarray(rng.normal(size=3), np.float32) for _ in range(2))
    want = jres.prediction_consistency_residuals(
        *(jnp.asarray(a) for a in (qb, tb, qe, te)),
        jslv.unpack_prior(jnp.asarray(prior)))
    got = tres.prediction_consistency_residuals(
        *(torch.from_numpy(a) for a in (qb, tb, qe, te)),
        torch.from_numpy(prior))
    _close(got.numpy(), want)
    assert got.shape == (12,) and np.abs(want).min() > 0


@pytest.mark.parametrize("loss", LOSSES)
def test_losses_match_reference(loss):
    rng = np.random.default_rng(17)
    r2 = np.concatenate([np.zeros(1), rng.uniform(0, 0.02, 500),
                         rng.uniform(0, 4.0, 500)]).astype(np.float32)
    sigma, a = np.float32(0.1), np.float32(0.05)
    jl, tl = getattr(jopt.LeastSquares, loss), getattr(topt.LeastSquares,
                                                       loss)
    for fn_j, fn_t in ((jres.irls_weight, tres.irls_weight),
                       (jres.robust_cost, tres.robust_cost)):
        want = fn_j(jl, jnp.asarray(r2), sigma, a)
        got = fn_t(tl, torch.from_numpy(r2), sigma, a)
        _close(got.numpy(), np.broadcast_to(np.asarray(want), r2.shape))
