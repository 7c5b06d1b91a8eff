"""The port's CT-BA (``ct_icp_torch/parallel/ct_ba.py`` and the plain
version of kernel K8, ``kernels/ct_ba_block.py``) against ct_icp_tpu's
``parallel/ct_ba.py`` on a one-device mesh, on the CPU.

The same synthetic problem (16 keyframes x 256 points, drawn from one numpy
generator by both packages' ``build_synthetic_problem``) goes through both
steps, block-Jacobi and PCG, for one and four steps: poses agree within
1e-5 m and 1e-5 rad, the cost within rtol 1e-4 above the float32 noise of
a converged window (atol 1e-9: residuals of ~1e-6 m over 4,096 rows).
Single frames of a problem with priors and gaps between keyframes
(edge_alpha 1.0 and 1.3: extrapolation past the end pose) give the same
J^T J, J^T r and GN delta as ``jax.jacfwd`` over the reference's residual
functions: J^T J within rtol 1e-4 plus an absolute 1e-4 of its largest
entry (the quaternion-dot rows sit at their minimum, where their tangent is
0 up to rounding), the delta within 1e-5. K8's plain version over 1, 2 and
4 inner iterations matches the reference's step of as many (its
fori_loop) on that problem, with the step test's tolerances; one call of n
iterations equals n calls of one, and the backend's 2 steps of 2 equal
one step of 4, bit for bit (the kernel runs them in one launch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ct_icp_torch.convert import ct_ba_from_numpy, ct_ba_to_numpy
from ct_icp_torch.kernels import ct_ba_block as k8
from ct_icp_torch.parallel import ct_ba as tba
from ct_icp_tpu.core import se3_np as s3n
from ct_icp_tpu.parallel import ct_ba as jba

FRAMES, POINTS = 16, 256
POSE_ATOL_M = 1e-5
POSE_ATOL_RAD = 1e-5
COST_RTOL, COST_ATOL = 1e-4, 1e-9


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("frames",))


def _problems(seed=0, noise=0.02):
    js, jp, jgt = jba.build_synthetic_problem(np.random.default_rng(seed),
                                              FRAMES, POINTS, noise=noise)
    ts, tp, tgt = tba.build_synthetic_problem(np.random.default_rng(seed),
                                              FRAMES, POINTS, noise=noise)
    return (js, jp, jgt), (ts, tp, tgt)


def _rot_gap_rad(qa, qb):
    qa = s3n.quat_normalize(np.asarray(qa, np.float64))
    qb = s3n.quat_normalize(np.asarray(qb, np.float64))
    d = np.clip(np.abs(np.sum(qa * qb, axis=-1)), 0.0, 1.0)
    return 2.0 * np.arccos(d)


def _assert_states_agree(js, ts):
    for f in ("tr_begin", "tr_end"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)),
                                   rtol=0, atol=POSE_ATOL_M)
    for f in ("quat_begin", "quat_end"):
        gap = _rot_gap_rad(getattr(ts, f).numpy(), getattr(js, f))
        assert gap.max() < POSE_ATOL_RAD, gap.max()


def test_synthetic_problem_matches_reference():
    (js, jp, jgt), (ts, tp, tgt) = _problems()
    for a, b in zip(list(js) + list(jp) + list(jgt),
                    list(ts) + list(tp) + list(tgt)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_numpy_round_trip():
    (js, jp, _), (ts, tp, _) = _problems(seed=3)
    cs, cp = ct_ba_from_numpy(js, jp)
    for a, b in zip(list(cs) + list(cp), list(ts) + list(tp)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    back = ct_ba_to_numpy(tp)
    assert set(back) == set(tba.CTBAProblem._fields)
    np.testing.assert_array_equal(back["anchors"], np.asarray(jp.anchors))


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("solver", ["jacobi", "pcg"])
def test_step_matches_reference(mesh1, solver, steps):
    (js, jp, _), _ = _problems(seed=5)
    jstep = jba.make_ct_ba_step(mesh1, num_inner_iters=2, beta=2.0,
                                solver=solver)
    tstep = tba.make_ct_ba_step(num_inner_iters=2, beta=2.0, solver=solver)
    ts, tp = ct_ba_from_numpy(js, jp)
    js, jp = jba.shard_problem(mesh1, js, jp)
    k8.launches = 0
    for _ in range(steps):
        js, jcost = jstep(js, jp)
        ts, tcost = tstep(ts, tp)
        _assert_states_agree(js, ts)
        np.testing.assert_allclose(float(tcost), float(jcost),
                                   rtol=COST_RTOL, atol=COST_ATOL)
    # the CPU takes the plain version: no launch
    assert k8.launches == 0


def test_converges_to_gt():
    """The reference's test_ct_ba_converges_to_gt on the port."""
    _, (state, problem, (gt_q, gt_tr)) = _problems(seed=0)
    step = tba.make_ct_ba_step(num_inner_iters=3)
    _, cost0 = step(state, problem)
    for _ in range(4):
        state, cost = step(state, problem)
    assert float(cost) < float(cost0) * 1e-2, (float(cost0), float(cost))
    err_t = np.linalg.norm(state.tr_end.numpy() - gt_tr.numpy()[1:], axis=-1)
    assert err_t.max() < 0.01, err_t
    dots = np.abs(np.sum(s3n.quat_normalize(
        state.quat_end.numpy().astype(np.float64)) * gt_q.numpy()[1:],
        axis=-1))
    assert np.all(dots > 1.0 - 1e-5)


def _gapped_problem(edge_alpha, frames=6):
    """The synthetic problem with the backend's priors (weight 1.5, the
    prior poses moved off the state) and ``edge_alpha`` on every edge."""
    rng = np.random.default_rng(11)
    js, jp, _ = jba.build_synthetic_problem(rng, frames, 128, noise=0.02)
    pn = {k: np.asarray(v) for k, v in jp._asdict().items()}
    for f in ("prior_tr_begin", "prior_tr_end"):
        pn[f] = (pn[f] + rng.normal(scale=0.01, size=pn[f].shape)
                 ).astype(np.float32)
    for f in ("prior_quat_begin", "prior_quat_end"):
        q = np.stack([s3n.quat_mul(s3n.quat_from_rotvec(
            rng.normal(scale=0.01, size=3)), x) for x in pn[f]])
        pn[f] = q.astype(np.float32)
    pn["prior_weight"] = np.full(frames, 1.5, np.float32)
    pn["edge_alpha"] = np.full(frames, edge_alpha, np.float32)
    pn["weights"] = rng.uniform(0.0, 2.0, pn["weights"].shape).astype(
        np.float32)
    pn["weights"][:, -7:] = 0.0      # a padded tail
    jp = jba.CTBAProblem(**{k: jnp.asarray(v) for k, v in pn.items()})
    return js, jp


def _reference_system(js, jp, f, beta, blocks):
    """J (jax.jacfwd), r0 of frame f through the reference's residual
    functions: point, continuity (neighbours at the state), prior rows; or
    point and prior rows only (``blocks``)."""
    qb, tb, qe, te = (np.asarray(x) for x in js)
    ext_q, ext_t = jax.vmap(jba._pose_at)(*js, jp.edge_alpha)
    n = qb.shape[0]
    fp, fn = (f - 1) % n, (f + 1) % n
    w_prev = 0.0 if f == 0 else 1.0
    w_next = 0.0 if f == n - 1 else 1.0
    args = (qb[f], tb[f], qe[f], te[f])
    p = jp

    def rfun(d):
        parts = [jba._frame_residuals(d, *args, p.raw[f], p.alphas[f],
                                      p.anchors[f], p.normals[f],
                                      p.weights[f])]
        if not blocks:
            parts.append(jba._continuity_residuals(
                d, *args, ext_q[fp], ext_t[fp], qb[fn], tb[fn], w_prev,
                w_next, beta, p.edge_alpha[f]))
        parts.append(jba._prior_residuals(
            d, *args, p.prior_quat_begin[f], p.prior_tr_begin[f],
            p.prior_quat_end[f], p.prior_tr_end[f], p.prior_weight[f]))
        return jnp.concatenate(parts)

    zero = jnp.zeros((12,), jnp.float32)
    jac = np.asarray(jax.jacfwd(rfun)(zero), np.float64)
    return jac, np.asarray(rfun(zero), np.float64)


def _assert_jtj_close(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("edge_alpha", [1.0, 1.3])
def test_gn_block_matches_reference_frames(edge_alpha):
    beta, damping = 2.0, 1e-3
    js, jp = _gapped_problem(edge_alpha)
    ts, tp = ct_ba_from_numpy(js, jp)
    out = k8.ct_ba_block(tba.pack_state(ts), tp, beta, damping, "gn")
    jq, jt_, jqe, jte, jcost = jax.vmap(
        lambda *a: jba._frame_gn_update(*a, beta=beta, damping=damping))(
        *js, jp.raw, jp.alphas, jp.anchors, jp.normals, jp.weights,
        jp.prior_quat_begin, jp.prior_tr_begin, jp.prior_quat_end,
        jp.prior_tr_end, jp.prior_weight, jp.edge_alpha,
        *_halo(js, jp.edge_alpha))
    for f in range(tp.raw.shape[0]):
        jac, r0 = _reference_system(js, jp, f, beta, blocks=False)
        jtj, jtr = jac.T @ jac, jac.T @ r0
        _assert_jtj_close(out.jtj[f].double().numpy(), jtj)
        _assert_jtj_close(out.jtr[f].double().numpy(), jtr)
        d = np.sqrt(np.maximum(np.diagonal(jtj), 1e-12))
        a = jtj / (d[:, None] * d[None, :]) + damping * np.eye(12)
        want = np.linalg.solve(a, -jtr / d) / d
        got = tba.gn_delta(out.jtj[f].double(), out.jtr[f].double(),
                           damping).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.poses[:, 4:7].numpy(), np.asarray(jt_),
                               rtol=0, atol=POSE_ATOL_M)
    np.testing.assert_allclose(out.poses[:, 11:14].numpy(), np.asarray(jte),
                               rtol=0, atol=POSE_ATOL_M)
    for got, want in ((out.poses[:, 0:4], jq), (out.poses[:, 7:11], jqe)):
        assert _rot_gap_rad(got.numpy(), want).max() < POSE_ATOL_RAD
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(jcost),
                               rtol=COST_RTOL, atol=COST_ATOL)


def _halo(js, edge_alpha):
    """The reference's one-shard halo (local_step's ppermute wraps)."""
    qb, tb, qe, te = js
    ext_q, ext_t = jax.vmap(jba._pose_at)(qb, tb, qe, te, edge_alpha)
    n = qb.shape[0]
    idx = jnp.arange(n)
    return (jnp.roll(ext_q, 1, 0), jnp.roll(ext_t, 1, 0),
            jnp.roll(qb, -1, 0), jnp.roll(tb, -1, 0),
            jnp.where(idx == 0, 0.0, 1.0), jnp.where(idx == n - 1, 0.0, 1.0))


@pytest.mark.parametrize("edge_alpha", [1.0, 1.3])
def test_blocks_match_reference_frames(edge_alpha):
    beta = 2.0
    js, jp = _gapped_problem(edge_alpha)
    ts, tp = ct_ba_from_numpy(js, jp)
    poses = tba.pack_state(ts)
    out = k8.ct_ba_block(poses, tp, beta, 1e-3, "blocks")
    assert out.poses is None
    n = tp.raw.shape[0]
    w_edge = jnp.where(jnp.arange(n) == n - 1, 0.0, 1.0)
    qb, tb, qe, te = js
    hp, gp, ce, a, b, cost = jax.vmap(
        lambda *x: jba._frame_blocks(*x, beta=beta))(
        qb, tb, qe, te, jp.raw, jp.alphas, jp.anchors, jp.normals,
        jp.weights, jp.prior_quat_begin, jp.prior_tr_begin,
        jp.prior_quat_end, jp.prior_tr_end, jp.prior_weight, jp.edge_alpha,
        jnp.roll(qb, -1, 0), jnp.roll(tb, -1, 0), w_edge)
    for f in range(n):
        jac, r0 = _reference_system(js, jp, f, beta, blocks=True)
        _assert_jtj_close(out.jtj[f].double().numpy(), jac.T @ jac)
        _assert_jtj_close(out.jtj[f].double().numpy(), np.asarray(hp[f]))
        _assert_jtj_close(out.jtr[f].double().numpy(), np.asarray(gp[f]))
    tce, ta, tb_ = tba.edge_blocks(poses, tp.edge_alpha,
                                   torch.from_numpy(np.array(w_edge)),
                                   beta)
    np.testing.assert_allclose(tce.numpy(), np.asarray(ce), atol=1e-6)
    for got, want in ((ta, a), (tb_, b)):
        _assert_jtj_close(got.double().numpy(), np.asarray(want))
    np.testing.assert_allclose(
        (out.cost + (tce * tce).sum(-1)).numpy(), np.asarray(cost),
        rtol=COST_RTOL, atol=COST_ATOL)


# the reference's block-Jacobi step by inner iterations, one jit each, on
# the module's one-device mesh
_JSTEPS = {}


def _reference_step(mesh, iters, beta):
    key = (iters, beta)
    if key not in _JSTEPS:
        _JSTEPS[key] = jba.make_ct_ba_step(mesh, num_inner_iters=iters,
                                           beta=beta)
    return _JSTEPS[key]


@pytest.mark.parametrize("iters", [1, 2, 4])
@pytest.mark.parametrize("edge_alpha", [1.0, 1.3])
def test_gn_iterations_match_reference(mesh1, edge_alpha, iters):
    """K8's plain version over ``iters`` inner iterations (each on the
    previous one's poses) against the reference's block-Jacobi step (its
    fori_loop of ``iters``), on a window with priors and gaps between the
    keyframes: the poses and the last iteration's total cost."""
    beta = 2.0
    js, jp = _gapped_problem(edge_alpha)
    ts, tp = ct_ba_from_numpy(js, jp)
    out = k8.ct_ba_block_plain(tba.pack_state(ts), tp, beta, 1e-3, "gn",
                               iters)
    js, jp = jba.shard_problem(mesh1, js, jp)
    js, jcost = _reference_step(mesh1, iters, beta)(js, jp)
    _assert_states_agree(js, tba.unpack_state(out.poses))
    np.testing.assert_allclose(float(out.total), float(jcost),
                               rtol=COST_RTOL, atol=COST_ATOL)


@pytest.mark.parametrize("iters", [2, 4])
def test_gn_iterations_in_one_call(iters):
    """One call of ``iters`` inner iterations gives, bit for bit, what
    ``iters`` calls of one give, each on the previous one's poses (so the
    kernel, which runs them in one launch, has one plain version)."""
    js, jp = _gapped_problem(1.3)
    ts, tp = ct_ba_from_numpy(js, jp)
    poses = tba.pack_state(ts)
    one = k8.ct_ba_block_plain(poses, tp, 2.0, 1e-3, "gn", iters)
    for _ in range(iters):
        step = k8.ct_ba_block_plain(poses, tp, 2.0, 1e-3, "gn")
        poses = step.poses
    for name in ("poses", "cost", "jtj", "jtr", "total"):
        assert torch.equal(getattr(one, name), getattr(step, name)), name
    # the total is the frames' costs summed in frame order
    assert torch.equal(one.total, k8.frame_order_sum(one.cost))


def test_backend_steps_fold_into_one():
    """The backend's 2 CT-BA steps of 2 inner iterations and the one step
    of 4 it runs instead: the same poses and cost, bit for bit."""
    js, jp = _gapped_problem(1.3)
    ts, tp = ct_ba_from_numpy(js, jp)
    step2 = tba.make_ct_ba_step(num_inner_iters=2, beta=2.0)
    a = ts
    for _ in range(2):
        a, cost_a = step2(a, tp)
    b, cost_b = tba.make_ct_ba_step(num_inner_iters=4, beta=2.0)(ts, tp)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(cost_a, cost_b)


def test_jacobi_step_is_one_call_on_the_cpu():
    """The plain version runs any window's inner iterations in one call."""
    cpu = torch.device("cpu")
    for f, iters in ((16, 2), (300, 4), (1, 4), (8, 1)):
        assert tba.jacobi_launches(f, 4096, iters, cpu) == 1


@pytest.mark.parametrize("edge_alpha", [1.0, 1.3])
@pytest.mark.parametrize("frames", [16, 20])
def test_chained_jacobi_step_matches(mesh1, monkeypatch, frames, edge_alpha):
    """The block-Jacobi step of a window whose K8 clusters do not all fit
    on the card (forced here through ``jacobi_launches``): its inner
    iterations as a chain of single-iteration calls equal the one-call
    path bit for bit, and the reference's ``make_ct_ba_step`` within
    ``test_gn_iterations_match_reference``'s tolerances, at the reference
    test's F = 16 and beyond."""
    beta, iters = 2.0, 2
    js, jp = _gapped_problem(edge_alpha, frames)
    ts, tp = ct_ba_from_numpy(js, jp)
    step = tba.make_ct_ba_step(num_inner_iters=iters, beta=beta)
    one, one_cost = step(ts, tp)
    calls = []
    plain = k8.ct_ba_block_plain

    def counted(poses, problem, beta, damping, mode, iters=1):
        calls.append(iters)
        return plain(poses, problem, beta, damping, mode, iters)

    monkeypatch.setattr(tba, "jacobi_launches",
                        lambda f, k, n, device: n)
    monkeypatch.setattr(k8, "ct_ba_block_plain", counted)
    chained, chained_cost = step(ts, tp)
    assert calls == [1] * iters
    for x, y in zip(one, chained):
        assert torch.equal(x, y)
    assert torch.equal(one_cost, chained_cost)
    js, jp = jba.shard_problem(mesh1, js, jp)
    js, jcost = _reference_step(mesh1, iters, beta)(js, jp)
    _assert_states_agree(js, chained)
    np.testing.assert_allclose(float(chained_cost), float(jcost),
                               rtol=COST_RTOL, atol=COST_ATOL)
