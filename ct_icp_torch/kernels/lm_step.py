"""K5 lm_step: the Levenberg-Marquardt inner loop of CT-ICP, its state kept
in a device tensor.

Replaces ``ct_icp_tpu/icp/solver.py:418-539`` (``_lm_inner_loop``) for the
CERES / ball-neighbourhood / point-to-plane / Cauchy / CONTINUOUS_TIME
statics of the driving and robust profiles. :func:`lm_loop` runs every step
of one LM call, up to ``done``, in one launch of ``csrc/lm_step.cu``: a
thread-block cluster of 16 CTAs that keep the rows in shared memory for the
call, sum the step's normal equations over the cluster's distributed shared
memory, and each do the prior rows, the damped 12x12 solve (one warp) and
accept/reject. Nothing is read back. Bound on the card: the serial chain of
a step (two cluster barriers, the solve), not bytes (a few hundred KB a
call) or operations (~3 Mflop a step at K = 3,000).

The step's state, ``STATE_SIZE`` floats (see ``init_state``):
  0:14 pose (qb, tb, qe, te)   14 lambda   15 cost0 (NaN before the first
  step)   16 done   17 the step's trial cost   18:30 delta
  30:44 trial pose   44:56 J^T W r   56:200 J^T W J (12 x 12)
A step after ``done`` would leave the state as it is; the loop stops there.

The problem rows are packed as f32[K, 12]: raw (3), alpha, anchor (3),
normal (3), geometric weight, ok (1.0 / 0.0) — see ``pack_rows``.

A CPU tensor takes :func:`lm_loop_plain` (:func:`lm_step_plain` until
``done``: the Jacobian by forward mode through the same residual functions,
``core/dual.py``, and ``torch.linalg.solve``); a CUDA tensor launches the
kernel or raises.
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

# launches of the CUDA kernel by lm_loop, one per call (reset freely)
launches = 0
# per device, the steps lm_loop ran (see steps_counter)
_steps = {}


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
    """Plain PyTorch version of one step of :func:`lm_loop`, in place on
    ``state``: a step after ``done`` leaves the state as it is."""
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


def lm_loop_plain(rows, prior, n_res, state, n_steps: int,
                  loss: LeastSquares, sigma, tolerant_a, freeze_begin: bool):
    """Plain PyTorch version of :func:`lm_loop`: ``lm_step_plain`` until
    ``done`` or ``n_steps`` steps, the reference's while loop (it reads
    ``done`` back each step). Returns the number of steps run."""
    steps = 0
    while steps < n_steps and not bool(state[S_DONE] != 0):
        lm_step_plain(rows, prior, n_res, state, loss, sigma, tolerant_a,
                      freeze_begin)
        steps += 1
    return steps


def steps_counter(device):
    """The int32[1] tensor on ``device`` to which every :func:`lm_loop`
    call adds the steps it ran (on the card, the kernel adds them). Only the
    checks read it; the main path never does."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _steps.get(dev)
    if t is None:
        t = _steps[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def reset_steps():
    """Zero every device's steps counter."""
    for t in _steps.values():
        t.zero_()


def lm_loop(rows, prior, n_res, state, n_steps: int, loss: LeastSquares,
            sigma, tolerant_a, freeze_begin: bool):
    """Up to ``n_steps`` LM steps of the problem ``rows`` (f32[K, 12], see
    ``pack_rows``) with the packed motion prior ``prior`` f32[14] and
    ``n_res`` (0-dim int32, the kept rows) on ``state`` f32[STATE_SIZE], in
    place, stopping at ``done``: one launch on the card, nothing read
    back."""
    if rows.device.type == "cpu":
        steps = lm_loop_plain(rows, prior, n_res, state, n_steps, loss,
                              sigma, tolerant_a, freeze_begin)
        steps_counter(rows.device).add_(steps)
        return
    global launches
    launch(rows, prior, n_res, state, n_steps, loss, sigma, freeze_begin)
    launches += 1


def launch(rows, prior, n_res, state, n_steps: int, loss: LeastSquares,
           sigma, freeze_begin: bool, defines=()):
    """One launch of ``csrc/lm_step.cu`` on CUDA tensors, counted by no
    launch counter; ``defines`` pick a measurement variant of the kernel
    (``tools/exp_lm_loop.py``), none the main path's."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"lm_loop: no kernel for {dev}")
    if loss != LeastSquares.CAUCHY:
        raise NotImplementedError(f"lm_loop: the kernel has the Cauchy loss "
                                  f"only, got {loss}")
    k = rows.shape[0]
    build.check_tensor(rows, torch.float32, (k, ROW), "lm_loop", "rows", dev)
    build.check_tensor(prior, torch.float32, (14,), "lm_loop", "prior", dev)
    build.check_tensor(n_res, torch.int32, (), "lm_loop", "n_res", dev)
    build.check_tensor(state, torch.float32, (STATE_SIZE,), "lm_loop",
                       "state", dev)
    fn = build.launcher("lm_step", "k5_lm_loop", _ARGTYPES, defines)
    status = fn(build.ptr(rows), k, build.ptr(prior), build.ptr(n_res),
                build.ptr(state), int(n_steps), float(sigma),
                int(bool(freeze_begin)), build.ptr(steps_counter(dev)),
                build.stream_of(rows))
    build.check_status(status, "lm_loop")


def rows_on_chip():
    """The rows the kernel's cluster keeps in shared memory; it reads the
    rows of a larger problem from global memory."""
    return build.launcher("lm_step", "k5_rows_on_chip", ())()


_ARGTYPES = (build.PTR, build.INT, build.PTR, build.PTR, build.PTR,
             build.INT, build.FLOAT, build.INT, build.PTR, build.PTR)
