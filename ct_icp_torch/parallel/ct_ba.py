"""Continuous-time bundle adjustment of a window of keyframes.

Counterpart of ``ct_icp_tpu/parallel/ct_ba.py``. The reference shards the
keyframe axis over a TPU mesh (``shard_map``, a ``ppermute`` halo of the
neighbour poses, ``psum`` of the costs). Here a window on one device
shifts along its frame axis for the halo (``torch.roll``: the wrapped end
values meet the zero end weights, as the reference's one-shard
``ppermute`` does) and sums plainly; a window sharded over the ranks of a
process group (``make_ct_ba_step(..., group=...)``, each rank a contiguous
slice of the frames: :func:`shard_problem`) exchanges the slice's end
poses with its neighbours (``parallel/comm.py::halo``) and sums over the
ranks with all_reduce.

Problem: per keyframe f, the 12-DoF continuous-time state (begin, end
pose); residuals
  * point-to-plane rows: every point of keyframe f touches only f's pose
    pair;
  * continuity rows between consecutive keyframes: pose_f(edge_alpha_f) ~
    begin(f+1) (position + quaternion dot);
  * prior rows anchoring each pose pair to its assembly-time value.

Every residual function takes a leading frame axis ([F, ...]; the reference
vmaps one frame) and the math namespace ``m``: ``core/se3.py`` (values) or
``core/dual.py``'s ``math`` (values with their forward-mode tangents, the
Jacobian ``jax.jacfwd`` takes there).

Solvers (:func:`make_ct_ba_step`):
  * ``"jacobi"``: damped block-Jacobi GN, one 12x12 solve a keyframe with
    its neighbours held at the previous iterate; a step's inner iterations
    are one launch of kernel K8 (``kernels/ct_ba_block.py``), or one launch
    an iteration where the window's clusters do not all fit on the card;
  * ``"pcg"``: the coupled block-tridiagonal GN step by preconditioned
    conjugate gradients; K8 gives the point + prior blocks, the 4 edge rows
    and the CG loop are F x 12 x 12 torch ops.
"""

from typing import NamedTuple

import numpy as np
import torch

from ct_icp_torch.core import dual
from ct_icp_torch.core import se3 as s3
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.kernels import ct_ba_block as k8
from ct_icp_torch.parallel import comm

# row layout of one keyframe's residual vector: K point rows, then
# CONTINUITY_ROWS (prev position, prev rotation, next position, next
# rotation), then PRIOR_ROWS (begin position, begin rotation, end position,
# end rotation)
CONTINUITY_ROWS = 8
PRIOR_ROWS = 8


class CTBAProblem(NamedTuple):
    """Fixed associations of one refinement pass (reference CTBAProblem:
    the same fields, with the same meaning)."""

    raw: torch.Tensor              # [F, K, 3] sensor-frame points
    alphas: torch.Tensor           # [F, K]
    anchors: torch.Tensor          # [F, K, 3] map anchor points
    normals: torch.Tensor          # [F, K, 3]
    weights: torch.Tensor          # [F, K] (0 disables a row)
    prior_quat_begin: torch.Tensor  # [F, 4]
    prior_tr_begin: torch.Tensor    # [F, 3]
    prior_quat_end: torch.Tensor    # [F, 4]
    prior_tr_end: torch.Tensor      # [F, 3]
    prior_weight: torch.Tensor      # [F]
    # where frame f's interpolation reaches begin(f+1)'s timestamp: 1.0 for
    # contiguous frames, > 1 across a gap (extrapolation)
    edge_alpha: torch.Tensor        # [F]


class CTBAState(NamedTuple):
    quat_begin: torch.Tensor  # [F, 4]
    tr_begin: torch.Tensor    # [F, 3]
    quat_end: torch.Tensor    # [F, 4]
    tr_end: torch.Tensor      # [F, 3]


def pack_state(state: CTBAState) -> torch.Tensor:
    """The poses as one [F, 14] tensor (qb, tb, qe, te): K8's layout."""
    return torch.cat(list(state), dim=1).contiguous()


def unpack_state(poses: torch.Tensor) -> CTBAState:
    return CTBAState(poses[:, 0:4], poses[:, 4:7], poses[:, 7:11],
                     poses[:, 11:14])


def seed_deltas(f: int, n: int, like: torch.Tensor):
    """Zero perturbations [F, n] as a dual of n tangents: tangent j moves
    column j of every frame (frames are independent, so each frame's
    Jacobian is its own)."""
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    return dual.Dual(torch.zeros((f, n), dtype=like.dtype, device=like.device),
                     eye[:, None, :].expand(n, f, n))


def apply_delta(delta, qb, tb, qe, te, m=s3):
    """residuals.apply_delta over a frame axis: the left-multiplicative
    so(3) x R^3 perturbation ``delta`` [..., 12] of (begin, end) poses."""
    dqb = m.quat_from_rotvec(delta[..., 0:3])
    dqe = m.quat_from_rotvec(delta[..., 6:9])
    return (m.quat_normalize(m.quat_mul(dqb, qb)), tb + delta[..., 3:6],
            m.quat_normalize(m.quat_mul(dqe, qe)), te + delta[..., 9:12])


def interp_world_points(qb, tb, qe, te, raw, alphas, m=s3):
    """residuals.interp_world_points over a frame axis: raw [F, K, 3] at
    their alpha-timestamps [F, K] under each frame's poses [F, 4] / [F, 3]
    (slerp + lerp, the pose broadcast over the frame's rows)."""
    qi, ti = m.se3_interpolate(qb[:, None, :], tb[:, None, :],
                               qe[:, None, :], te[:, None, :], alphas)
    return m.quat_rotate(qi, raw) + ti


def _frame_residuals(delta, qb, tb, qe, te, raw, alphas, anchors, normals,
                     weights, m=s3):
    """Point-to-plane rows [F, K] under a 12-DoF perturbation; a row of
    weight 0 is exactly 0 (its tangents too)."""
    qb2, tb2, qe2, te2 = apply_delta(delta, qb, tb, qe, te, m)
    world = interp_world_points(qb2, tb2, qe2, te2, raw, alphas, m)
    r = weights * m.sum((world - anchors) * normals, axis=-1)
    return dual.where(weights != 0, r, torch.zeros_like(weights))


def _quat_dot(q, p, m):
    return m.sum(m.quat_normalize(q) * p, axis=-1)


def _prior_residuals(delta, qb, tb, qe, te, pqb, ptb, pqe, pte, w, m=s3):
    """Anchor rows [F, 8] to the prior pose pair: position difference and
    quaternion-dot rotation distance, begin then end."""
    qb2, tb2, qe2, te2 = apply_delta(delta, qb, tb, qe, te, m)
    db = _quat_dot(qb2, pqb, m)
    de = _quat_dot(qe2, pqe, m)
    wv = w[:, None]
    return m.concatenate([
        wv * (tb2 - ptb), (w * (1.0 - db * db))[:, None],
        wv * (te2 - pte), (w * (1.0 - de * de))[:, None]], axis=-1)


def _pose_at(qb, tb, qe, te, alpha, m=s3):
    """Continuous pose of each keyframe at interpolation parameter
    ``alpha`` [F] (slerp + lerp; alpha > 1 extrapolates past the end)."""
    return m.se3_interpolate(m.quat_normalize(qb), tb, m.quat_normalize(qe),
                             te, alpha)


def _continuity_residuals(delta, qb, tb, qe, te, q_prev_ext, t_prev_ext,
                          q_next_begin, t_next_begin, w_prev, w_next, beta,
                          edge_alpha, m=s3):
    """Continuity rows [F, 8] against the neighbours held fixed:
    begin(f) ~ pose_{f-1}(edge_alpha_{f-1}) and pose_f(edge_alpha_f) ~
    begin(f+1); position and quaternion dot."""
    qb2, tb2, qe2, te2 = apply_delta(delta, qb, tb, qe, te, m)
    bp = beta * w_prev
    bn = beta * w_next
    dq_prev = _quat_dot(qb2, q_prev_ext, m)
    qx, tx = _pose_at(qb2, tb2, qe2, te2, edge_alpha, m)
    dq_next = _quat_dot(qx, q_next_begin, m)
    return m.concatenate([
        bp[:, None] * (tb2 - t_prev_ext),
        (bp * (1.0 - dq_prev * dq_prev))[:, None],
        bn[:, None] * (tx - t_next_begin),
        (bn * (1.0 - dq_next * dq_next))[:, None]], axis=-1)


def _edge_residuals(d_self, d_next, qb, tb, qe, te, edge_alpha, qb_n, tb_n,
                    w, beta, m=s3):
    """Continuity rows [F, 4] of each edge pose_f(edge_alpha_f) ~ begin(f+1)
    as a function of both frames' perturbations (the coupled solver's
    form)."""
    qb2, tb2, qe2, te2 = apply_delta(d_self, qb, tb, qe, te, m)
    qx, tx = _pose_at(qb2, tb2, qe2, te2, edge_alpha, m)
    qn2, tn2, _, _ = apply_delta(d_next, qb_n, tb_n, qb_n, tb_n, m)
    bw = beta * w
    dq = m.sum(m.quat_normalize(qx) * m.quat_normalize(qn2), axis=-1)
    return m.concatenate([bw[:, None] * (tx - tn2),
                          (bw * (1.0 - dq * dq))[:, None]], axis=-1)


def neighbours(qb, tb, qe, te, edge_alpha, halo=None):
    """The halo of the block-Jacobi step: each frame's predecessor
    extrapolated to its begin timestamp, its successor's begin pose, and
    the end weights (no continuity before the first frame or after the
    last). With ``halo`` f32[2, 16] (:func:`halo_rows`, the frames a rank's
    slice of a sharded window) the first frame's predecessor and the last
    frame's successor and their weights come from it. Returns (q_prev_ext,
    t_prev_ext, q_next_begin, t_next_begin, w_prev, w_next)."""
    f = qb.shape[0]
    ext_q, ext_t = _pose_at(qb, tb, qe, te, edge_alpha)
    idx = torch.arange(f, device=qb.device)
    one = torch.ones(f, dtype=qb.dtype, device=qb.device)
    zero = torch.zeros_like(one)
    q_prev, t_prev = torch.roll(ext_q, 1, 0), torch.roll(ext_t, 1, 0)
    q_next, t_next = torch.roll(qb, -1, 0), torch.roll(tb, -1, 0)
    w_prev = torch.where(idx == 0, zero, one)
    w_next = torch.where(idx == f - 1, zero, one)
    if halo is not None:
        hq, ht = _pose_at(halo[0:1, 0:4], halo[0:1, 4:7], halo[0:1, 7:11],
                          halo[0:1, 11:14], halo[0:1, 14])
        first, last = idx == 0, idx == f - 1
        on_prev = first & (halo[0, 15] != 0)
        q_prev = torch.where(on_prev[:, None], hq, q_prev)
        t_prev = torch.where(on_prev[:, None], ht, t_prev)
        on_next = last & (halo[1, 15] != 0)
        q_next = torch.where(on_next[:, None], halo[1:2, 0:4], q_next)
        t_next = torch.where(on_next[:, None], halo[1:2, 4:7], t_next)
        w_prev = torch.where(first, halo[0, 15], w_prev)
        w_next = torch.where(last, halo[1, 15], w_next)
    return q_prev, t_prev, q_next, t_next, w_prev, w_next


def halo_rows(poses, edge_alpha, group):
    """The halo of a rank's slice ``poses`` [F, 14] of a sharded window
    (:func:`neighbours`, K8's ``halo``): f32[2, 16], row 0 the previous
    rank's last frame (its iterate, its edge_alpha, 1; rank 0: 0, no
    edge), row 1 the next rank's first frame (its iterate, 0, 1; the last
    rank: 0). One ring exchange (``comm.halo``)."""
    n, r = comm.size(group), comm.rank(group)
    pad = poses.new_zeros((2,))
    last = torch.cat([poses[-1], edge_alpha[-1:], pad[:1]])
    first = torch.cat([poses[0], pad])
    prev_last, next_first = comm.halo(first, last, group)
    out = torch.stack([prev_last, next_first])
    out[0, 15] = 0.0 if r == 0 else 1.0
    out[1, 14] = 0.0
    out[1, 15] = 0.0 if r == n - 1 else 1.0
    return out.contiguous()


def frame_system(poses, problem: CTBAProblem, beta: float,
                 continuity: bool = True, halo=None):
    """The row pass of every keyframe: residuals r0 [F, R] and their
    Jacobian [F, R, 12] at delta = 0 by forward mode (``core/dual.py``),
    with R = K + 8 + 8 (continuity rows, against the neighbours of
    :func:`neighbours` with ``halo``, included) or K + 8
    (``continuity=False``: the point and prior rows of ``_frame_blocks``)."""
    qb, tb, qe, te = unpack_state(poses)
    p = problem
    f = qb.shape[0]
    d = seed_deltas(f, 12, poses)
    m = dual.math
    parts = [_frame_residuals(d, qb, tb, qe, te, p.raw, p.alphas, p.anchors,
                              p.normals, p.weights, m)]
    if continuity:
        parts.append(_continuity_residuals(
            d, qb, tb, qe, te,
            *neighbours(qb, tb, qe, te, p.edge_alpha, halo), beta,
            p.edge_alpha,
            m))
    parts.append(_prior_residuals(d, qb, tb, qe, te, p.prior_quat_begin,
                                  p.prior_tr_begin, p.prior_quat_end,
                                  p.prior_tr_end, p.prior_weight, m))
    r = m.concatenate(parts, axis=-1)
    return r.v, r.jacobian()


def gn_delta(jtj, jtr, damping: float):
    """The Jacobi-scaled damped solve of ``_frame_gn_update``:
    (J^T J / d d^T + damping I) x = -J^T r / d, delta = x / d, with
    d = sqrt(max(diag(J^T J), 1e-12)); batched over frames."""
    d = torch.sqrt(torch.clamp_min(torch.diagonal(jtj, dim1=-2, dim2=-1),
                                   1e-12))
    eye = torch.eye(12, dtype=jtj.dtype, device=jtj.device)
    a = jtj / (d[..., :, None] * d[..., None, :]) + damping * eye
    return torch.linalg.solve(a, (-jtr / d)[..., None])[..., 0] / d


def _frame_gn_update(poses, problem: CTBAProblem, beta: float,
                     damping: float, halo=None):
    """One damped block-GN update of every keyframe, its neighbours held at
    ``poses`` and, for a rank's slice, ``halo`` (plain version of K8's
    ``gn`` mode). Returns (new poses
    [F, 14], cost [F] (continuity rows halved: each edge appears in both
    of its frames), J^T J [F, 12, 12], J^T r [F, 12])."""
    r0, jac = frame_system(poses, problem, beta, halo=halo)
    jt = jac.transpose(-1, -2)
    jtj = jt @ jac
    jtr = (jt @ r0[..., None])[..., 0]
    delta = gn_delta(jtj, jtr, damping)
    new = apply_delta(delta, *unpack_state(poses))
    k = problem.raw.shape[1]
    sq = r0 * r0
    cost = (sq[:, :k].sum(-1) + 0.5 * sq[:, k:k + CONTINUITY_ROWS].sum(-1)
            + sq[:, k + CONTINUITY_ROWS:].sum(-1))
    return torch.cat(new, dim=1), cost, jtj, jtr


def _frame_blocks(poses, problem: CTBAProblem):
    """The point + prior blocks of every keyframe for the coupled solver
    (plain version of K8's ``blocks`` mode): (hp [F, 12, 12], gp [F, 12],
    the point + prior cost [F])."""
    r0, jac = frame_system(poses, problem, 0.0, continuity=False)
    jt = jac.transpose(-1, -2)
    return jt @ jac, (jt @ r0[..., None])[..., 0], (r0 * r0).sum(-1)


def edge_blocks(poses, edge_alpha, w_edge, beta: float, qb_n=None,
                tb_n=None):
    """Each edge's rows ce [F, 4] and their Jacobians with respect to the
    frame (a [F, 4, 12]) and its successor (b [F, 4, 12]), whose begin pose
    is ``qb_n`` / ``tb_n`` [F, ...] (default: the next frame of the
    window, wrapping)."""
    qb, tb, qe, te = unpack_state(poses)
    if qb_n is None:
        qb_n, tb_n = torch.roll(qb, -1, 0), torch.roll(tb, -1, 0)
    d = seed_deltas(qb.shape[0], 24, poses)
    ce = _edge_residuals(d[:, 0:12], d[:, 12:24], qb, tb, qe, te,
                         edge_alpha, qb_n, tb_n, w_edge, beta, dual.math)
    jac = ce.jacobian()
    return ce.v, jac[..., 0:12], jac[..., 12:24]


def jacobi_launches(f: int, k: int, iters: int, device) -> int:
    """The K8 launches that run a block-Jacobi step of ``iters`` inner
    iterations over ``f`` frames of ``k`` rows on ``device``: one where its
    clusters can all be resident at once (its frames wait on each other's
    iteration flags), or on the CPU (the plain version); else ``iters``
    launches of one iteration, which wait on nothing and run in waves. The
    two give the same poses and cost bit for bit."""
    if iters <= 1 or device.type == "cpu" \
            or k8.resident(f, k, device):
        return 1
    return iters


def shard_problem(state: CTBAState, problem: CTBAProblem, group=None,
                  device=None):
    """This rank's contiguous slice of the window's frames (reference
    :386-392, the keyframe axis sharded over the mesh): frames
    [r F / n, (r + 1) F / n) of every field, on ``device`` (default:
    where they are). F must divide by the ranks."""
    n, r = comm.size(group), comm.rank(group)
    f = state.quat_begin.shape[0]
    if f % n:
        raise ValueError(f"shard_problem: {f} frames over {n} ranks")
    lo, hi = r * f // n, (r + 1) * f // n

    def cut(x):
        x = x[lo:hi].contiguous()
        return x if device is None else x.to(device)

    return (CTBAState(*(cut(x) for x in state)),
            CTBAProblem(*(cut(x) for x in problem)))


def make_ct_ba_step(num_inner_iters: int = 2, beta: float = 1.0,
                    damping: float = 1e-3, solver: str = "jacobi",
                    num_cg_iters: int = 16, group=None):
    """The CT-BA step: step(state, problem) -> (state, total cost of the
    last inner iteration, a 0-dim tensor). Nothing is read back.

    With a ``group`` of n > 1 ranks, ``state`` and ``problem`` are this
    rank's slice of the window (:func:`shard_problem`) and the cost is the
    window's: a block-Jacobi step is one single-iteration K8 launch an
    inner iteration with the slice's halo exchanged before each
    (:func:`halo_rows`; the reference's ppermute), the PCG step's shifts
    are ring exchanges and its dot products and cost all_reduce sums.
    Without a group, or with one of one rank, it is the one-device step.

    ``solver``:
      * ``"jacobi"``: damped block-Jacobi GN; the ``num_inner_iters``
        iterations are one K8 launch (each reads the previous iterate's
        poses; the cost is the last one's, summed in frame order on the
        device), or a chain of single-iteration launches for a window
        whose clusters do not all fit on the card (:func:`jacobi_launches`);
      * ``"pcg"``: the coupled GN step: the block-tridiagonal normal
        equations over all keyframes by ``num_cg_iters`` iterations of
        block-diagonal preconditioned CG, on K8's point + prior blocks."""
    if solver not in ("jacobi", "pcg"):
        raise ValueError(f"unknown CT-BA solver {solver!r}")
    sharded = comm.size(group) > 1

    def step_jacobi_mesh(state: CTBAState, problem: CTBAProblem):
        poses = pack_state(state)
        total = torch.zeros((1,), dtype=poses.dtype, device=poses.device)
        for _ in range(num_inner_iters):
            halo = halo_rows(poses, problem.edge_alpha, group)
            out = k8.ct_ba_block(poses, problem, beta, damping, "gn", 1,
                                 halo=halo)
            poses = out.poses
            total = out.total.reshape(1)
        return unpack_state(poses), comm.sum_(total.clone(), group)[0]

    def step_jacobi(state: CTBAState, problem: CTBAProblem):
        poses = pack_state(state)
        if num_inner_iters == 0:
            return unpack_state(poses), torch.zeros(
                (), dtype=poses.dtype, device=poses.device)
        n = jacobi_launches(poses.shape[0], problem.raw.shape[1],
                            num_inner_iters, poses.device)
        for _ in range(n):
            out = k8.ct_ba_block(poses, problem, beta, damping, "gn",
                                 num_inner_iters // n)
            poses = out.poses
        return unpack_state(poses), out.total

    def step_pcg(state: CTBAState, problem: CTBAProblem):
        poses = pack_state(state)
        f = poses.shape[0]
        dev, dt = poses.device, poses.dtype
        idx = torch.arange(f, device=dev)
        # no edge after the window's last frame (on the last rank)
        last = comm.rank(group) == comm.size(group) - 1
        w_edge = torch.where((idx == f - 1) & last,
                             torch.zeros(f, dtype=dt, device=dev),
                             torch.ones(f, dtype=dt, device=dev))

        def shift_fwd(x):
            """x_f -> the value frame f + 1 sees from frame f (across a
            slice's start, the previous rank's last row; on one device a
            roll, whose wrap meets the last edge's zero weight)."""
            prev_last, _ = comm.halo(x[0], x[-1], group)
            return torch.cat([prev_last[None], x[:-1]], 0)

        def shift_bwd(x):
            """x_f -> x_{f+1}, aligned at frame f."""
            _, next_first = comm.halo(x[0], x[-1], group)
            return torch.cat([x[1:], next_first[None]], 0)

        def pdot(p, q):
            return comm.sum_((p * q).sum().reshape(1), group)[0]

        cost = torch.zeros((), dtype=dt, device=dev)
        for _ in range(num_inner_iters):
            blk = k8.ct_ba_block(poses, problem, beta, damping, "blocks")
            nxt = shift_bwd(poses)
            ce, a, b = edge_blocks(poses, problem.edge_alpha, w_edge, beta,
                                   nxt[:, 0:4], nxt[:, 4:7])
            cost = comm.sum_((blk.cost + (ce * ce).sum(-1)).sum().reshape(1),
                             group)[0]
            # block-tridiagonal assembly: H_ff = hp + a^T a + the incoming
            # edge's b^T b, U_f = a_f^T b_f, g_f = gp + a^T ce + the
            # incoming edge's b^T ce
            u = torch.einsum("fri,frj->fij", a, b)
            g = blk.jtr + torch.einsum("fri,fr->fi", a, ce)
            g = g + shift_fwd(torch.einsum("fri,fr->fi", b, ce))
            h = (blk.jtj + torch.einsum("fri,frj->fij", a, a)
                 + shift_fwd(torch.einsum("fri,frj->fij", b, b)))
            diag = torch.diagonal(h, dim1=-2, dim2=-1)
            h = h + torch.diag_embed(damping * torch.clamp_min(diag, 1e-8)
                                     + 1e-8)
            hinv = torch.linalg.inv(h)

            def matvec(x):
                y = torch.einsum("fij,fj->fi", h, x)
                y = y + torch.einsum("fij,fj->fi", u, shift_bwd(x))
                return y + shift_fwd(torch.einsum("fji,fj->fi", u, x))

            # PCG on H x = -g
            x = torch.zeros_like(g)
            r = -g
            z = torch.einsum("fij,fj->fi", hinv, r)
            p = z
            rs = pdot(r, z)
            for _ in range(num_cg_iters):
                hp_v = matvec(p)
                alpha = rs / torch.clamp_min(pdot(p, hp_v), 1e-20)
                x = x + alpha * p
                r = r - alpha * hp_v
                z = torch.einsum("fij,fj->fi", hinv, r)
                rs_new = pdot(r, z)
                p = z + (rs_new / torch.clamp_min(rs, 1e-20)) * p
                rs = rs_new
            poses = torch.cat(apply_delta(x, *unpack_state(poses)), dim=1)
        return unpack_state(poses), cost

    if solver == "pcg":
        return step_pcg
    return step_jacobi_mesh if sharded else step_jacobi


def build_synthetic_problem(rng, num_frames: int, num_points: int,
                            noise: float = 0.01, device="cpu"):
    """A synthetic CT-BA problem for tests (the reference's, draw for draw
    from the numpy generator ``rng``): random plane anchors under a smooth
    ground-truth trajectory, the initial state perturbed. Returns (state,
    problem, (gt_q [F + 1, 4], gt_tr [F + 1, 3]))."""
    t = np.linspace(0, 1, num_frames + 1)
    gt_tr = np.stack([5 * t, 2 * np.sin(t * 2), 0.1 * t], axis=-1)
    yaw = 0.3 * t
    gt_q = s3n.quat_from_rotvec(
        np.stack([np.zeros_like(yaw), np.zeros_like(yaw), yaw], -1))

    raw = rng.uniform(-10, 10, (num_frames, num_points, 3))
    alphas = rng.uniform(0, 1, (num_frames, num_points))
    normals = rng.normal(size=(num_frames, num_points, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)

    # world point under the GT interpolated pose -> the anchor on its plane
    anchors = np.zeros_like(raw)
    for f in range(num_frames):
        q0 = np.broadcast_to(gt_q[f], (num_points, 4))
        q1 = np.broadcast_to(gt_q[f + 1], (num_points, 4))
        t0 = np.broadcast_to(gt_tr[f], (num_points, 3))
        t1 = np.broadcast_to(gt_tr[f + 1], (num_points, 3))
        qi, ti = s3n.se3_interpolate(q0, t0, q1, t1, alphas[f])
        anchors[f] = s3n.quat_rotate(qi, raw[f]) + ti

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    state = CTBAState(
        quat_begin=f32(np.stack(
            [s3n.quat_mul(s3n.quat_from_rotvec(
                rng.normal(scale=noise, size=3)), gt_q[f])
             for f in range(num_frames)])),
        tr_begin=f32(gt_tr[:-1]
                     + rng.normal(scale=noise, size=(num_frames, 3))),
        quat_end=f32(np.stack(
            [s3n.quat_mul(s3n.quat_from_rotvec(
                rng.normal(scale=noise, size=3)), gt_q[f + 1])
             for f in range(num_frames)])),
        tr_end=f32(gt_tr[1:]
                   + rng.normal(scale=noise, size=(num_frames, 3))),
    )
    problem = CTBAProblem(
        raw=f32(raw), alphas=f32(alphas), anchors=f32(anchors),
        normals=f32(normals),
        weights=torch.ones((num_frames, num_points), dtype=torch.float32,
                           device=device),
        # priors off (weight 0): the synthetic problem grades convergence
        # to the ground truth from a perturbed start
        prior_quat_begin=state.quat_begin, prior_tr_begin=state.tr_begin,
        prior_quat_end=state.quat_end, prior_tr_end=state.tr_end,
        prior_weight=torch.zeros((num_frames,), dtype=torch.float32,
                                 device=device),
        # contiguous frames: end(f) is begin(f + 1)'s pose
        edge_alpha=torch.ones((num_frames,), dtype=torch.float32,
                              device=device),
    )
    return state, problem, (f32(gt_q), f32(gt_tr))
