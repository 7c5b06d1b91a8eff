"""K5 lm_step: one Levenberg-Marquardt step of the CT-ICP inner loop, its
state kept in a device tensor.

Replaces the body of ``ct_icp_tpu/icp/solver.py:452-534``
(``_lm_inner_loop``) for the CERES / ball-neighbourhood / point-to-plane /
Cauchy / CONTINUOUS_TIME statics of the driving and robust profiles. Kernel:
``csrc/lm_step.cu`` — four launches a step (rows: Jacobian by forward mode
and the J^T W J / J^T W r block sums; one block: the prior rows, the damped
12x12 solve, the trial pose; rows: the trial cost; one thread: accept or
reject, lambda, cost0, pose, ``done``), none of which is read back, so a
loop of N steps is enqueued at once. Bound on the card: launches, not bytes
(a few hundred KB and ~10 Mflop a step at K = 4096).

The step's state, ``STATE_SIZE`` floats (see ``init_state``):
  0:14 pose (qb, tb, qe, te)   14 lambda   15 cost0 (NaN before the first
  step)   16 done   17 the step's trial cost   18:30 delta
  30:44 trial pose   44:56 J^T W r   56:200 J^T W J (12 x 12)
Every step after ``done`` leaves the state as it is.

The problem rows are packed as f32[K, 12]: raw (3), alpha, anchor (3),
normal (3), geometric weight, ok (1.0 / 0.0) — see ``pack_rows``.

A CPU tensor takes :func:`lm_step_plain` (the Jacobian by forward mode
through the same residual functions, ``core/dual.py``, and
``torch.linalg.solve``: the port's loop body in the kernel's masked form); a
CUDA tensor launches the kernel or raises.
"""

import torch

from ct_icp_torch.config.options import IcpDistance, LeastSquares
from ct_icp_torch.core import dual
from ct_icp_torch.core import se3 as s3
from ct_icp_torch.icp import residuals as res
from ct_icp_torch.kernels import build

STATE_SIZE = 200
S_LAM, S_COST0, S_DONE, S_COST1 = 14, 15, 16, 17
S_DELTA, S_TRIAL, S_JTR, S_JTJ = 18, 30, 44, 56
ROW = 12
_THREADS = 128        # threads per block of the kernel's row passes

# launches of the CUDA kernel by lm_step, one per step (reset freely)
launches = 0


def init_state(qb, tb, qe, te):
    """The state of a loop about to start from the pose (qb, tb, qe, te):
    lambda 1e-4, cost0 unknown (NaN: the first step sets it), not done."""
    state = torch.zeros(STATE_SIZE, dtype=torch.float32, device=qb.device)
    state[0:4], state[4:7], state[7:11], state[11:14] = qb, tb, qe, te
    state[S_LAM] = 1e-4
    state[S_COST0] = float("nan")
    return state


def pack_rows(raw, alphas, anchors, normals, geom_w, ok):
    """The problem rows f32[K, 12] the step reads."""
    return torch.cat([raw, alphas[:, None], anchors, normals, geom_w[:, None],
                      ok.to(raw.dtype)[:, None]], dim=1).contiguous()


def residual_vector(delta, state, rows, prior, n_res, m=s3):
    """The LM problem's residuals [K + 10] (K point-to-plane rows, masked
    where not ok, then the 10 motion-prior rows) at the perturbation
    ``delta`` of the state's pose; with ``m = dual.math`` and a dual
    ``delta``, their Jacobian too."""
    raw, alphas = rows[:, 0:3], rows[:, 3]
    anchors, normals, geom_w = rows[:, 4:7], rows[:, 7:10], rows[:, 10]
    q0, t0, q1, t1 = res.apply_delta(delta, state[0:4], state[4:7],
                                     state[7:11], state[11:14], m=m)
    world = res.interp_world_points(q0, t0, q1, t1, raw, alphas, m=m)
    geo = res.geometric_residuals(IcpDistance.POINT_TO_PLANE, world,
                                  anchors, normals, geom_w, m=m)[:, 0]
    geo = dual.where(rows[:, 11] != 0, geo, torch.zeros_like(rows[:, 11]))
    pri = res.motion_prior_residuals(q0, t0, q1, t1, prior, n_res, m=m)
    return m.concatenate([geo, pri])


def lm_step_plain(rows, prior, n_res, state, loss: LeastSquares, sigma,
                  tolerant_a, freeze_begin: bool):
    """Plain PyTorch version of :func:`lm_step`, in place on ``state``: a
    step after ``done`` leaves the state as it is."""
    # the rows that are not ok add exact zeros to every sum: drop them
    rows = rows[rows[:, 11] != 0]
    k = rows.shape[0]
    dev, dt = rows.device, rows.dtype

    def total_cost(r):
        pr, prior_r = r[:k], r[k:]
        return (torch.sum(res.robust_cost(loss, pr * pr, sigma, tolerant_a))
                + torch.sum(prior_r * prior_r))

    zero = torch.zeros(12, dtype=dt, device=dev)
    lin = residual_vector(dual.Dual.seed(zero), state, rows, prior, n_res,
                          m=dual.math)
    r0, jac = lin.v, lin.jacobian()                     # [K + 10], [.., 12]
    cost0 = torch.where(torch.isnan(state[S_COST0]), total_cost(r0),
                        state[S_COST0])
    pr = r0[:k]
    w_pts = res.irls_weight(loss, pr * pr, sigma, tolerant_a)
    w = torch.cat([w_pts, torch.ones(r0.shape[0] - k, dtype=dt, device=dev)])
    if freeze_begin:
        jac = torch.cat([torch.zeros_like(jac[:, 0:6]), jac[:, 6:]], 1)
    jw = jac * w[:, None]
    jtj = jw.T @ jac
    jtr = jw.T @ r0
    diag = torch.diagonal(jtj)
    # freeze unobservable dimensions (e.g. the begin pose when every alpha
    # is 1 on the first frames): Jacobi scaling would otherwise hide the
    # rank deficiency and amplify float32 noise
    degen = diag <= 1e-7 * torch.clamp_min(diag.max(), 1e-12)
    keep = (~degen).to(dt)
    d = torch.where(degen, torch.ones_like(diag),
                    torch.sqrt(torch.clamp_min(diag, 1e-20)))
    a = jtj / (d[:, None] * d[None, :])
    a = a * keep[:, None] * keep[None, :] + torch.diag(degen.to(dt))
    a = a + state[S_LAM] * torch.diag(torch.diagonal(a)) \
        + 1e-7 * torch.eye(12, dtype=dt, device=dev)
    b = -jtr / d * keep
    delta = torch.linalg.solve(a, b) / d * keep

    pose = state[0:14]
    trial = torch.cat(res.apply_delta(delta, pose[0:4], pose[4:7],
                                      pose[7:11], pose[11:14]))
    cost1 = total_cost(residual_vector(delta, state, rows, prior, n_res))
    accept = cost1 < cost0
    # ceres::Solve's function_tolerance exit (Ceres default 1e-6)
    done = accept & (cost0 - cost1 <= 1e-6 * (cost0 + 1e-30))
    same = torch.cat(res.apply_delta(zero, pose[0:4], pose[4:7], pose[7:11],
                                     pose[11:14]))
    lam = state[S_LAM]
    new = torch.cat([
        torch.where(accept, trial, same),
        torch.stack([
            torch.where(accept, torch.clamp_min(lam / 3.0, 1e-8),
                        torch.clamp_max(lam * 4.0, 1e4)),
            torch.where(accept, cost1, cost0), done.to(dt), cost1]),
        delta, trial, jtr, jtj.reshape(-1)])
    state.copy_(torch.where(state[S_DONE] != 0, state, new))


def lm_step(rows, prior, n_res, state, loss: LeastSquares, sigma,
            tolerant_a, freeze_begin: bool):
    """One LM step of the problem ``rows`` (f32[K, 12], see ``pack_rows``)
    with the packed motion prior ``prior`` f32[14] and ``n_res`` (0-dim
    int32, the kept rows) on ``state`` f32[STATE_SIZE], in place."""
    if rows.device.type == "cpu":
        # a step after done would leave the state as it is: on the CPU,
        # where reading the state is no device sync, skip it
        if bool(state[S_DONE] != 0):
            return
        return lm_step_plain(rows, prior, n_res, state, loss, sigma,
                             tolerant_a, freeze_begin)
    global launches
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"lm_step: no kernel for {dev}")
    if loss != LeastSquares.CAUCHY:
        raise NotImplementedError(f"lm_step: the kernel has the Cauchy loss "
                                  f"only, got {loss}")
    k = rows.shape[0]
    build.check_tensor(rows, torch.float32, (k, ROW), "lm_step", "rows", dev)
    build.check_tensor(prior, torch.float32, (14,), "lm_step", "prior", dev)
    build.check_tensor(n_res, torch.int32, (), "lm_step", "n_res", dev)
    build.check_tensor(state, torch.float32, (STATE_SIZE,), "lm_step",
                       "state", dev)
    nb = max((k + _THREADS - 1) // _THREADS, 1)
    part_a = torch.empty((nb, 91), dtype=torch.float32, device=dev)
    part_c = torch.empty((nb,), dtype=torch.float32, device=dev)
    fn = build.launcher("lm_step", "k5_lm_step", _ARGTYPES)
    status = fn(build.ptr(rows), k, build.ptr(prior), build.ptr(n_res),
                build.ptr(state), float(sigma), int(bool(freeze_begin)),
                build.ptr(part_a), build.ptr(part_c), build.stream_of(rows))
    build.check_status(status, "lm_step")
    launches += 1


_ARGTYPES = (build.PTR, build.INT, build.PTR, build.PTR, build.PTR,
             build.FLOAT, build.INT, build.PTR, build.PTR, build.PTR)
