"""K5 lm_step: the Levenberg-Marquardt inner loop of CT-ICP, its state kept
in a device tensor.

Replaces ``ct_icp_tpu/icp/solver.py:418-539`` (``_lm_inner_loop``) for
every statics: the residual ``Family`` (point-to-plane, -point, -line,
-distribution, the ROBUST solver's mixed rows), the five losses, the [14]
motion prior or the [41] prior with its 12 prediction-consistency rows,
the Jacobian by forward mode or analytic, the begin-column freeze of
SIMPLE. :func:`lm_loop` runs every step
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

The problem rows are packed as f32[K, ROW_WIDTH[family]]: raw (3),
alpha, anchor (3), the family's fields, geometric weight, ok (1.0 / 0.0)
— see ``pack_rows``; the point-to-plane rows are the 12 floats they were.

A CPU tensor takes :func:`lm_loop_plain` (:func:`lm_step_plain` until
``done``: the Jacobian by forward mode through the same residual functions,
``core/dual.py``, or analytic as the reference's branch, and
``torch.linalg.solve``); a CUDA tensor launches the kernel or raises.
"""

import enum

import torch

from ct_icp_torch.config.options import IcpDistance, LeastSquares, Solver
from ct_icp_torch.core import dual
from ct_icp_torch.core import se3 as s3
from ct_icp_torch.icp import residuals as res
from ct_icp_torch.kernels import build

STATE_SIZE = 200
S_LAM, S_COST0, S_DONE, S_COST1 = 14, 15, 16, 17
S_DELTA, S_TRIAL, S_JTR, S_JTJ = 18, 30, 44, 56
ROW = 12


class Family(enum.IntEnum):
    """The residual family of a problem's rows (a library of
    csrc/lm_step.cu each, ``library``)."""
    PLANE = 0          # point-to-plane, one scalar row a keypoint
    POINT = 1          # point-to-point, three
    LINE = 2           # point-to-line, one
    DISTRIBUTION = 3   # point-to-distribution, one
    ROBUST = 4         # the ROBUST solver's mixed rows, three


# floats a packed row, and scalar residual rows a packed row
ROW_WIDTH = {Family.PLANE: 12, Family.POINT: 12, Family.LINE: 12,
             Family.DISTRIBUTION: 18, Family.ROBUST: 25}
ROWS_PER_POINT = {Family.PLANE: 1, Family.POINT: 3, Family.LINE: 1,
                  Family.DISTRIBUTION: 1, Family.ROBUST: 3}
_DISTANCE = {Family.PLANE: IcpDistance.POINT_TO_PLANE,
             Family.POINT: IcpDistance.POINT_TO_POINT,
             Family.LINE: IcpDistance.POINT_TO_LINE,
             Family.DISTRIBUTION: IcpDistance.POINT_TO_DISTRIBUTION}

# launches of the CUDA kernel by lm_loop, one per call (reset freely)
launches = 0
# per device, the steps lm_loop ran (see steps_counter)
_steps = {}


def family_of(solver: Solver, distance: IcpDistance) -> Family:
    """The rows' family for a solver and distance (solver.py:364-415)."""
    if solver == Solver.ROBUST:
        return Family.ROBUST
    return {d: f for f, d in _DISTANCE.items()}[distance]


def init_state(qb, tb, qe, te):
    """The state of a loop about to start from the pose (qb, tb, qe, te):
    lambda 1e-4, cost0 unknown (NaN: the first step sets it), not done."""
    state = torch.zeros(STATE_SIZE, dtype=torch.float32, device=qb.device)
    state[0:4], state[4:7], state[7:11], state[11:14] = qb, tb, qe, te
    state[S_LAM] = 1e-4
    state[S_COST0] = float("nan")
    return state


def pack_rows(raw, alphas, anchors, normals, geom_w, ok,
              family: Family = Family.PLANE, lines=None, cov_inv=None,
              cls=None):
    """The problem rows f32[K, ROW_WIDTH[family]] the step reads: raw (3),
    alpha, anchor (3), then the family's fields, the geometric weight and
    ok (1.0 / 0.0) last. PLANE: the normal (3); POINT: 3 unused; LINE: the
    line (3); DISTRIBUTION: the covariance inverse (9, row-major); ROBUST:
    the normal, the line, the covariance inverse (zeros without the
    distribution) and the class (0 other, 1 planar, 2 linear)."""
    dt = raw.dtype
    head = [raw, alphas[:, None], anchors]
    if family in (Family.PLANE, Family.POINT):
        body = [normals if family == Family.PLANE
                else torch.zeros_like(anchors)]
    elif family == Family.LINE:
        body = [lines]
    elif family == Family.DISTRIBUTION:
        body = [cov_inv.reshape(-1, 9)]
    else:
        cov = (torch.zeros((raw.shape[0], 9), dtype=dt, device=raw.device)
               if cov_inv is None else cov_inv.reshape(-1, 9))
        body = [normals, lines, cov, cls.to(dt)[:, None]]
    return torch.cat(head + body + [geom_w[:, None], ok.to(dt)[:, None]],
                     dim=1).contiguous()


def _row_residuals(family: Family, world, rows, use_distribution: bool, m):
    """The geometric rows [K, R] of the packed ``rows`` at ``world``
    (solver.py:371-408)."""
    anchors, geom_w = rows[:, 4:7], rows[:, -2]
    if family == Family.PLANE:
        return res.geometric_residuals(IcpDistance.POINT_TO_PLANE, world,
                                       anchors, rows[:, 7:10], None, None,
                                       geom_w, m=m)
    if family in (Family.POINT, Family.LINE):
        return res.geometric_residuals(_DISTANCE[family], world, anchors,
                                       None, rows[:, 7:10], None, geom_w, m=m)
    if family == Family.DISTRIBUTION:
        return res.geometric_residuals(
            IcpDistance.POINT_TO_DISTRIBUTION, world, anchors, None, None,
            rows[:, 7:16].reshape(-1, 3, 3), geom_w, m=m)
    normals, lines = rows[:, 7:10], rows[:, 10:13]
    cov_inv, cls = rows[:, 13:22].reshape(-1, 3, 3), rows[:, 22]
    # mixed rows by neighbourhood class: the scalar distances in row 0
    # (plane, line or distribution) or the point-to-point 3-vector
    r_plane = res.geometric_residuals(IcpDistance.POINT_TO_PLANE, world,
                                      anchors, normals, lines, cov_inv,
                                      geom_w, m=m)[:, 0]
    r_line = res.geometric_residuals(IcpDistance.POINT_TO_LINE, world,
                                     anchors, normals, lines, cov_inv,
                                     geom_w, m=m)[:, 0]
    zero = torch.zeros_like(cls)
    if use_distribution:
        r_other = m.stack([res.geometric_residuals(
            IcpDistance.POINT_TO_DISTRIBUTION, world, anchors, normals, lines,
            cov_inv, geom_w, m=m)[:, 0], zero, zero], axis=-1)
    else:
        r_other = res.geometric_residuals(IcpDistance.POINT_TO_POINT, world,
                                          anchors, normals, lines, cov_inv,
                                          geom_w, m=m)
    scalar = m.where(cls == 1, r_plane, r_line)
    return m.where((cls > 0)[:, None], m.stack([scalar, zero, zero], axis=-1),
                   r_other)


def _prior_rows(q0, t0, q1, t1, prior, n_res, m):
    rows = [res.motion_prior_residuals(q0, t0, q1, t1, prior, n_res, m=m)]
    if prior.shape[0] >= 41:
        rows.append(res.prediction_consistency_residuals(q0, t0, q1, t1,
                                                         prior, m=m))
    return rows[0] if len(rows) == 1 else m.concatenate(rows)


def residual_vector(delta, state, rows, prior, n_res, m=s3,
                    family: Family = Family.PLANE,
                    use_distribution: bool = True):
    """The LM problem's residuals [K * R + P] (the K rows' R scalar rows,
    zero where not ok, then the P = 10 motion-prior rows, + 12
    prediction-consistency rows with a [41] prior) at the perturbation
    ``delta`` of the state's pose; with ``m = dual.math`` and a dual
    ``delta``, their Jacobian too."""
    raw, alphas = rows[:, 0:3], rows[:, 3]
    q0, t0, q1, t1 = res.apply_delta(delta, state[0:4], state[4:7],
                                     state[7:11], state[11:14], m=m)
    world = res.interp_world_points(q0, t0, q1, t1, raw, alphas, m=m)
    geo = _row_residuals(family, world, rows, use_distribution, m)
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    geo = dual.where((rows[:, -1] != 0)[:, None], geo, zero).reshape(-1)
    pri = _prior_rows(q0, t0, q1, t1, prior, n_res, m)
    return m.concatenate([geo, pri])


def _analytic_linearization(state, rows, prior, n_res, family: Family):
    """The analytic branch (solver.py:460-483): the rows' residuals and
    their Jacobian from the world-point gradient by cross products at the
    state's pose, the prior rows by forward mode. Returns (r0, jac)."""
    raw, alphas, ok = rows[:, 0:3], rows[:, 3], rows[:, -1] != 0
    q0, t0, q1, t1 = state[0:4], state[4:7], state[7:11], state[11:14]
    world = res.interp_world_points(q0, t0, q1, t1, raw, alphas)
    cov = (rows[:, 7:16].reshape(-1, 3, 3)
           if family == Family.DISTRIBUTION else None)
    r_geo, g = res.geometric_residuals_and_grad(
        _DISTANCE[family], world, rows[:, 4:7], rows[:, 7:10],
        rows[:, 7:10], cov, rows[:, -2])
    r_geo = torch.where(ok[:, None], r_geo, torch.zeros_like(r_geo))
    g = torch.where(ok[:, None, None], g, torch.zeros_like(g))
    jac_geo = res.ct_jacobian_from_world_grad(g, world, t0, t1, alphas)
    zero = torch.zeros(12, dtype=rows.dtype, device=rows.device)

    def prior_fun(d, m):
        pose = res.apply_delta(d, q0, t0, q1, t1, m=m)
        return _prior_rows(*pose, prior, n_res, m)

    lin = prior_fun(dual.Dual.seed(zero), dual.math)
    return (torch.cat([r_geo.reshape(-1), lin.v]),
            torch.cat([jac_geo.reshape(-1, 12), lin.jacobian()]))


def lm_step_plain(rows, prior, n_res, state, loss: LeastSquares, sigma,
                  tolerant_a, freeze_begin: bool,
                  family: Family = Family.PLANE,
                  use_distribution: bool = True, analytic: bool = False):
    """Plain PyTorch version of one step of :func:`lm_loop`, in place on
    ``state``: a step after ``done`` leaves the state as it is."""
    n_rows = rows.shape[0]
    # the rows that are not ok add zeros to every sum (rho(0) each to the
    # cost, which only the TOLERANT loss makes non-zero): drop them
    rows = rows[rows[:, -1] != 0]
    per = ROWS_PER_POINT[family]
    k = rows.shape[0] * per
    dev, dt = rows.device, rows.dtype
    rho0 = res.robust_cost(loss, torch.zeros((), dtype=dt, device=dev),
                           sigma, tolerant_a)
    n_dropped = (n_rows - rows.shape[0]) * per

    def total_cost(r):
        pr, prior_r = r[:k], r[k:]
        c = torch.sum(res.robust_cost(loss, pr * pr, sigma, tolerant_a))
        if n_dropped and bool(rho0 != 0):
            c = c + n_dropped * rho0
        return c + torch.sum(prior_r * prior_r)

    def values(d):
        return residual_vector(d, state, rows, prior, n_res, family=family,
                               use_distribution=use_distribution)

    zero = torch.zeros(12, dtype=dt, device=dev)
    if analytic:
        r0, jac = _analytic_linearization(state, rows, prior, n_res, family)
        first_cost = total_cost(values(zero))
    else:
        lin = residual_vector(dual.Dual.seed(zero), state, rows, prior,
                              n_res, m=dual.math, family=family,
                              use_distribution=use_distribution)
        r0, jac = lin.v, lin.jacobian()                 # [K R + P], [.., 12]
        first_cost = total_cost(r0)
    cost0 = torch.where(torch.isnan(state[S_COST0]), first_cost,
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
    cost1 = total_cost(values(delta))
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
                  loss: LeastSquares, sigma, tolerant_a, freeze_begin: bool,
                  family: Family = Family.PLANE,
                  use_distribution: bool = True, analytic: bool = False):
    """Plain PyTorch version of :func:`lm_loop`: ``lm_step_plain`` until
    ``done`` or ``n_steps`` steps, the reference's while loop (it reads
    ``done`` back each step). Returns the number of steps run."""
    steps = 0
    while steps < n_steps and not bool(state[S_DONE] != 0):
        lm_step_plain(rows, prior, n_res, state, loss, sigma, tolerant_a,
                      freeze_begin, family, use_distribution, analytic)
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
            sigma, tolerant_a, freeze_begin: bool,
            family: Family = Family.PLANE, use_distribution: bool = True,
            analytic: bool = False):
    """Up to ``n_steps`` LM steps of the problem ``rows`` (f32[K,
    ROW_WIDTH[family]], see ``pack_rows``) with the packed prior ``prior``
    (f32[14], the motion model; f32[41] with the prediction block) and
    ``n_res`` (0-dim int32, the kept rows) on ``state`` f32[STATE_SIZE], in
    place, stopping at ``done``: one launch on the card, nothing read back.
    ``use_distribution``: a ROBUST row of class "other" is the
    point-to-distribution distance (else point-to-point); ``analytic``: the
    rows' Jacobian by cross products from the world-point gradient (not for
    ROBUST)."""
    if analytic and family == Family.ROBUST:
        raise ValueError("lm_loop: the analytic Jacobian is not for the "
                         "ROBUST rows")
    if rows.device.type == "cpu":
        steps = lm_loop_plain(rows, prior, n_res, state, n_steps, loss,
                              sigma, tolerant_a, freeze_begin, family,
                              use_distribution, analytic)
        steps_counter(rows.device).add_(steps)
        return
    global launches
    launch(rows, prior, n_res, state, n_steps, loss, sigma, tolerant_a,
           freeze_begin, family, use_distribution, analytic)
    launches += 1


# the loss codes of csrc/lm_step.cu
_LOSS = {LeastSquares.STANDARD: 0, LeastSquares.CAUCHY: 1,
         LeastSquares.HUBER: 2, LeastSquares.TOLERANT: 3,
         LeastSquares.TRUNCATED: 4}


def launch(rows, prior, n_res, state, n_steps: int, loss: LeastSquares,
           sigma, tolerant_a, freeze_begin: bool,
           family: Family = Family.PLANE, use_distribution: bool = True,
           analytic: bool = False, defines=()):
    """One launch of ``csrc/lm_step.cu`` on CUDA tensors, counted by no
    launch counter; ``defines`` pick a measurement variant of the kernel
    (``tools/exp_lm_loop.py``), none the main path's."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"lm_loop: no kernel for {dev}")
    k = rows.shape[0]
    build.check_tensor(rows, torch.float32, (k, ROW_WIDTH[Family(family)]),
                       "lm_loop", "rows", dev)
    if prior.shape not in ((14,), (41,)):
        raise ValueError(f"lm_loop: prior must be f32[14] or f32[41], got "
                         f"{tuple(prior.shape)}")
    build.check_tensor(prior, torch.float32, tuple(prior.shape), "lm_loop",
                       "prior", dev)
    build.check_tensor(n_res, torch.int32, (), "lm_loop", "n_res", dev)
    build.check_tensor(state, torch.float32, (STATE_SIZE,), "lm_loop",
                       "state", dev)
    fn = build.launcher("lm_step", "k5_lm_loop", _ARGTYPES,
                        library(family, defines))
    flags = (int(bool(freeze_begin)) | (int(bool(use_distribution)) << 1)
             | (int(bool(analytic)) << 2))
    status = fn(build.ptr(rows), k, int(family), build.ptr(prior),
                int(prior.shape[0]), build.ptr(n_res), build.ptr(state),
                int(n_steps), _LOSS[loss], float(sigma), float(tolerant_a),
                flags, build.ptr(steps_counter(dev)), build.stream_of(rows))
    build.check_status(status, "lm_loop")


def rows_on_chip(family: Family = Family.PLANE):
    """The rows the kernel's cluster keeps in shared memory for ``family``;
    it reads the rows of a larger problem from global memory."""
    return build.launcher("lm_step", "k5_rows_on_chip", (),
                          library(family))()


def library(family: Family, defines=()):
    """The defines of ``family``'s library of csrc/lm_step.cu (one a
    family, ``build.PARTS``), ``defines`` (a measurement variant's) first."""
    return tuple(defines) + (f"K5_FAMILY={int(family)}",)


_ARGTYPES = (build.PTR, build.INT, build.INT, build.PTR, build.INT,
             build.PTR, build.PTR, build.INT, build.INT, build.FLOAT,
             build.FLOAT, build.INT, build.PTR, build.PTR)
