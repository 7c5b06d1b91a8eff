"""Residuals, robust losses (as IRLS weights) and geometric weighting (torch).

Counterpart of ``ct_icp_tpu/icp/residuals.py``, the subset the driving
profile runs: point-to-plane residuals, the Cauchy loss (and the other
closed-form losses), the DoRegisterCeres weighting (reference
ct_icp.cpp:577-587), the PreviousFrameMotionModel rows and the
continuous-time transform the Jacobian is taken through.

The pose functions take the math namespace ``m``: ``core/se3.py`` (torch
values, the default) or ``core/dual.py``'s ``math`` (values with their
forward-mode tangents, for the LM step's Jacobian).
"""

import torch

from ct_icp_torch.config.options import IcpDistance, LeastSquares
from ct_icp_torch.core import se3 as s3


def irls_weight(loss: LeastSquares, r2, sigma, tolerant_a):
    """IRLS weight rho'(s) at s = r^2 (Ceres losses with scale ls_sigma)."""
    b = sigma * sigma
    if loss == LeastSquares.STANDARD:
        return torch.ones_like(r2)
    if loss == LeastSquares.CAUCHY:
        return 1.0 / (1.0 + r2 / b)
    if loss == LeastSquares.HUBER:
        return torch.clamp_max(sigma / torch.sqrt(torch.clamp_min(r2, 1e-20)),
                               1.0)
    if loss == LeastSquares.TOLERANT:
        return torch.sigmoid((r2 - tolerant_a) / max(sigma, 1e-9))
    if loss == LeastSquares.TRUNCATED:
        return (r2 < b).to(r2.dtype)
    raise ValueError(f"Unknown loss {loss}")


def robust_cost(loss: LeastSquares, r2, sigma, tolerant_a):
    """rho(r^2) — the total cost the IRLS iteration is descending."""
    b = sigma * sigma
    if loss == LeastSquares.STANDARD:
        return r2
    if loss == LeastSquares.CAUCHY:
        return b * torch.log1p(r2 / b)
    if loss == LeastSquares.HUBER:
        return torch.where(r2 <= b, r2,
                           2.0 * torch.sqrt(b * torch.clamp_min(r2, 0.0)) - b)
    if loss == LeastSquares.TOLERANT:
        s = max(sigma, 1e-9)
        return s * torch.logaddexp((r2 - tolerant_a) / s, torch.zeros_like(r2))
    if loss == LeastSquares.TRUNCATED:
        return torch.clamp_max(r2, b)
    raise ValueError(f"Unknown loss {loss}")


def ceres_path_weights(a2d, closest_dist, power_planarity, weight_alpha,
                       weight_neighborhood, max_dist_to_plane,
                       min_num_neighbors):
    """w = la * a2D^power + ln * exp(-d_closest / (max_dist_to_plane * kMin))
    with (la, ln) the normalized (weight_alpha, weight_neighborhood)."""
    lam_a = abs(weight_alpha)
    lam_n = abs(weight_neighborhood)
    ssum = max(lam_a + lam_n, 1e-12)
    lam_a, lam_n = lam_a / ssum, lam_n / ssum
    return (lam_a * torch.pow(torch.clamp_min(a2d, 0.0), power_planarity)
            + lam_n * torch.exp(-closest_dist
                                / (max_dist_to_plane * min_num_neighbors)))


def apply_delta(delta, qb, tb, qe, te, m=s3):
    """Left-multiplicative so(3) x R^3 perturbation of (begin, end) poses."""
    # rotvecs as [1, 3] rows: torch.where over 0-dim float32 operands gives
    # a float64 tangent under torch.func.jacfwd (torch 2.13)
    dqb = m.quat_from_rotvec(delta[None, 0:3])[0]
    dqe = m.quat_from_rotvec(delta[None, 6:9])[0]
    return (m.quat_normalize(m.quat_mul(dqb, qb)), tb + delta[3:6],
            m.quat_normalize(m.quat_mul(dqe, qe)), te + delta[9:12])


def interp_world_points(qb, tb, qe, te, raw, alphas, m=s3):
    """CT transform of raw points at their alpha-timestamps
    (reference CTFunctor, cost_functions.h:200-218: slerp quat + lerp tr)."""
    n = raw.shape[0]
    qi, ti = m.se3_interpolate(qb.expand(n, 4), tb.expand(n, 3),
                               qe.expand(n, 4), te.expand(n, 3), alphas)
    return m.quat_rotate(qi, raw) + ti


def geometric_residuals(distance: IcpDistance, world, anchors, normals,
                        weights, m=s3):
    """Per-point residual rows [N, 1] (point-to-plane: the path this port
    covers; the other distances are not ported yet)."""
    if distance != IcpDistance.POINT_TO_PLANE:
        raise NotImplementedError(f"{distance} is not ported")
    r = m.sum((world - anchors) * normals, axis=-1)
    return (weights * r)[:, None]


def motion_prior_residuals(qb, tb, qe, te, prior, num_residuals, m=s3):
    """The PreviousFrameMotionModel constraint rows [10]
    (reference src/ct_icp/motion_model.cpp:12-61); ``prior`` is the packed
    [14] vector of registration.make_prior."""
    n = torch.clamp_min(num_residuals.to(torch.float32), 0.0)
    w_loc = torch.sqrt(n * prior[10])
    w_or = torch.sqrt(n * prior[11])
    w_cv = torch.sqrt(n * prior[12])
    w_sv = torch.sqrt(n * prior[13])
    prev_q, prev_t, prev_v = prior[0:4], prior[4:7], prior[7:10]
    r_loc = w_loc * (tb - prev_t)
    dotq = m.sum(m.quat_normalize(qb) * prev_q, axis=-1)
    r_or = (w_or * (1.0 - dotq * dotq))[None]
    r_cv = w_cv * ((te - tb) - prev_v)
    r_sv = w_sv * (tb - te)
    return m.concatenate([r_loc, r_or, r_cv, r_sv])
