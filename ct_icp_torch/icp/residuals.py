"""Residuals, robust losses (as IRLS weights) and geometric weighting (torch).

Counterpart of ``ct_icp_tpu/icp/residuals.py``: the four ICP distances
(reference cost_functions.h:32-183) with their world-point gradients and
the analytic continuous-time Jacobian built from them, the five robust
losses as IRLS weights and costs, the DoRegisterCeres weighting (reference
ct_icp.cpp:577-587), the PreviousFrameMotionModel and
PredictionConsistencyModel rows and the continuous-time transform the
Jacobian is taken through.

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
                        lines, cov_inv, weights, m=s3):
    """Per-point residual rows [N, R] for the chosen ICP distance (reference
    cost_functions.h:32-183): R = 3 for POINT_TO_POINT, else 1. ``lines``
    [N, 3] and ``cov_inv`` [N, 3, 3] are read only by their distances (None
    elsewhere)."""
    diff = world - anchors
    if distance == IcpDistance.POINT_TO_PLANE:
        r = m.sum(diff * normals, axis=-1)
        return (weights * r)[:, None]
    if distance == IcpDistance.POINT_TO_POINT:
        return weights[:, None] * diff
    if distance == IcpDistance.POINT_TO_LINE:
        d = lines / torch.clamp_min(
            torch.linalg.norm(lines, dim=-1, keepdim=True), 1e-12)
        c = m.cross(d, diff)
        r = m.sqrt(m.sum(c * c, axis=-1) + 1e-12)
        return (weights * r)[:, None]
    if distance == IcpDistance.POINT_TO_DISTRIBUTION:
        # r = w * diff^T (cov + eps I)^-1 diff
        cd = m.stack([m.sum(cov_inv[:, i, :] * diff, axis=-1)
                      for i in range(3)], axis=-1)
        return (weights * m.sum(diff * cd, axis=-1))[:, None]
    raise ValueError(f"Unknown distance {distance}")


def geometric_residuals_and_grad(distance: IcpDistance, world, anchors,
                                 normals, lines, cov_inv, weights):
    """Residual rows [N, R] and their gradient with respect to the world
    point [N, R, 3]: the cheap half of the analytic continuous-time
    Jacobian (reference DoRegisterGaussNewton, ct_icp.cpp:813-850)."""
    diff = world - anchors
    if distance == IcpDistance.POINT_TO_PLANE:
        r = torch.sum(diff * normals, dim=-1)
        return (weights * r)[:, None], (weights[:, None] * normals)[:, None]
    if distance == IcpDistance.POINT_TO_POINT:
        eye = torch.eye(3, dtype=world.dtype, device=world.device).expand(
            world.shape[:-1] + (3, 3))
        return weights[:, None] * diff, weights[:, None, None] * eye
    if distance == IcpDistance.POINT_TO_LINE:
        d = lines / torch.clamp_min(
            torch.linalg.norm(lines, dim=-1, keepdim=True), 1e-12)
        c = s3.cross(d, diff)
        nc = torch.sqrt(torch.sum(c * c, dim=-1) + 1e-12)
        # dr/dworld = (c/|c|)^T [d]x = -(d x c_hat)
        g = -s3.cross(d, c / nc[:, None])
        return (weights * nc)[:, None], (weights[:, None] * g)[:, None]
    if distance == IcpDistance.POINT_TO_DISTRIBUTION:
        cd = torch.einsum("nij,nj->ni", cov_inv, diff)
        r = torch.sum(diff * cd, dim=-1)
        g = 2.0 * cd
        return (weights * r)[:, None], (weights[:, None] * g)[:, None]
    raise ValueError(f"Unknown distance {distance}")


def ct_jacobian_from_world_grad(g, world, tb, te, alphas):
    """[N, R, 12] continuous-time Jacobian from world-point gradients ``g``
    [N, R, 3], to first order in the inter-pose rotation (the reference GN
    path's cross products, ct_icp.cpp:813-850): the rotation columns of a
    row are (1 - a) and a times cross(R p, g), the translation columns
    (1 - a) and a times g, with R p = world - lerp(tb, te, a)."""
    a = alphas[:, None, None]
    t_interp = ((1.0 - alphas[:, None]) * tb[None, :]
                + alphas[:, None] * te[None, :])
    v = world - t_interp
    rot = s3.cross(v[:, None, :].expand(g.shape), g)
    return torch.cat([(1.0 - a) * rot, (1.0 - a) * g, a * rot, a * g],
                     dim=-1)


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


def prediction_consistency_residuals(qb, tb, qe, te, prior, m=s3):
    """The PredictionConsistencyModel rows [12] (reference
    motion_model.cpp:188-283): location and orientation of the begin and
    end poses against a prediction, and the relative-pose functor
    (cost_functions.h:231-268) tying begin^-1 * end to the predicted
    relative transform. ``prior`` is the packed [41] vector of
    ``PredictionConsistencyModel.device_prior``; its weights are already
    scaled (not by sqrt(N)), and a zero weight disables its rows."""
    qbn = m.quat_normalize(qb)
    qen = m.quat_normalize(qe)
    r_b_loc = prior[35] * (tb - prior[18:21])
    dq_b = m.sum(qbn * prior[14:18], axis=-1)
    r_b_rot = (prior[36] * (1.0 - dq_b * dq_b))[None]
    r_e_loc = prior[37] * (te - prior[25:28])
    dq_e = m.sum(qen * prior[21:25], axis=-1)
    r_e_rot = (prior[38] * (1.0 - dq_e * dq_e))[None]
    rq, rt = m.se3_compose(*m.se3_inverse(qbn, tb), qen, te)
    dq_r = m.sum(m.quat_normalize(rq) * prior[28:32], axis=-1)
    r_r_rot = (prior[39] * (1.0 - dq_r * dq_r))[None]
    r_r_tr = prior[40] * (rt - prior[32:35])
    return m.concatenate([r_b_loc, r_b_rot, r_e_loc, r_e_rot, r_r_rot,
                          r_r_tr])
