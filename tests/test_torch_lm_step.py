"""The port's LM inner loop in kernel K5's form (a fixed number of steps,
every step after the function-tolerance exit masked, nothing read per
step; kernels/lm_step.py's plain version on the CPU) against ct_icp_tpu's
``_lm_inner_loop`` on the ``__graft_entry__.entry()`` problem: pose within
1e-5 m and 1e-4 deg, cost within 1e-5 relative. Also: the masked loop
equals the early-exit loop bit for bit, and the step's forward-mode
Jacobian equals ``torch.func.jacfwd``'s."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import __graft_entry__
from ct_icp_torch.config.options import LeastSquares
from ct_icp_torch.core import dual
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.icp import solver as tslv
from ct_icp_torch.kernels import lm_step as lm
from ct_icp_tpu.config.options import MotionModelOptions
from ct_icp_tpu.core.pose import Pose, TrajectoryFrame
from ct_icp_tpu.icp import solver as jslv
from ct_icp_tpu.icp.registration import make_prior

LS_STEPS = 20
# the initial poses: identity (every keypoint on the nlerp fallback of the
# slerp), and a begin/end pair 0.8 deg apart (the slerp branch)
POSES = {
    "identity": ([1.0, 0, 0, 0], [0.0, 0, 0], [1.0, 0, 0, 0], [0.0, 0, 0]),
    "moving": ([1.0, 0, 0, 0], [0.02, -0.01, 0.0],
               [0.99997, 0.001, -0.002, 0.007], [0.35, 0.04, 0.01]),
}


def _problem(pose_name):
    """The entry problem at an initial pose, its association by
    ct_icp_tpu, and a motion prior with every beta set."""
    _fn, args = __graft_entry__.entry()
    level, raw, alphas, valid, _qb, _tb, _qe, _te, _prior, dyn = args
    dyn = dyn._replace(ls_max_num_iters=jnp.int32(LS_STEPS))
    qb, tb, qe, te = (jnp.asarray(np.asarray(x, np.float32)
                                  / (np.linalg.norm(x) if len(x) == 4
                                     else 1.0))
                      for x in POSES[pose_name])
    statics = jslv.SolverStatics(num_keypoints=raw.shape[0],
                                 max_neighbors=20, level_index=0,
                                 voxel_neighborhood=2)
    prob = jslv._build_problem(statics, dyn, level, raw, alphas, valid, qb,
                               tb, qe, te, te)
    unit = lambda q: s3n.quat_normalize(np.array(q))
    prev = TrajectoryFrame(Pose(unit([1.0, 0, 0, -0.004]), [-0.3, 0.01, 0.0]),
                           Pose(unit([1.0, 0, 0, -0.001]), [-0.02, 0.0, 0.0]))
    mm = dataclasses.replace(MotionModelOptions(),
                             beta_location_consistency=0.001,
                             beta_orientation_consistency=0.01,
                             beta_constant_velocity=0.001,
                             beta_small_velocity=0.0005)
    prior = make_prior(prev, mm, np.zeros(3))
    return statics, dyn, raw, alphas, prob, (qb, tb, qe, te), prior


def _port_inputs(dyn, raw, alphas, prob, pose, prior):
    anchors, normals, _lines, _cov, geom_w, ok, _cls, _planes = prob
    t = lambda x: torch.from_numpy(np.array(x))
    rows = lm.pack_rows(t(raw), t(alphas), t(anchors), t(normals),
                        t(geom_w), t(ok))
    state = lm.init_state(*(t(x) for x in pose))
    n_res = t(ok).sum(dtype=torch.int32)
    return rows, state, n_res, t(prior)


def _run_port(dyn, rows, state, n_res, prior, early_exit):
    """LS_STEPS plain steps; with ``early_exit`` the loop stops at done."""
    for _ in range(LS_STEPS):
        if early_exit and state[lm.S_DONE] != 0:
            break
        lm.lm_step_plain(rows, prior, n_res, state, LeastSquares.CAUCHY,
                         np.float32(dyn.ls_sigma),
                         np.float32(dyn.ls_tolerant_min_threshold), False)
    return state


@pytest.mark.parametrize("pose_name", sorted(POSES))
def test_masked_loop_matches_reference(pose_name):
    statics, dyn, raw, alphas, prob, pose, prior = _problem(pose_name)
    anchors, normals, lines, cov, geom_w, ok, cls, _ = prob
    want = jax.jit(lambda *a: jslv._lm_inner_loop(statics, dyn, *a))(
        raw, alphas, anchors, normals, lines, cov, geom_w, ok, cls, *pose,
        jslv.unpack_prior(jnp.asarray(prior)))
    rows, state, n_res, tprior = _port_inputs(dyn, raw, alphas, prob, pose,
                                              prior)
    state = _run_port(dyn, rows, state, n_res, tprior, early_exit=False)
    # the loop converged (done) before its last step: the masked steps ran
    assert state[lm.S_DONE] == 1
    for sl, (wq, wt) in ((slice(0, 7), (want[0], want[1])),
                         (slice(7, 14), (want[2], want[3]))):
        q, tr = state[sl][0:4].numpy(), state[sl][4:7].numpy()
        assert np.linalg.norm(tr - np.asarray(wt)) < 1e-5
        assert s3n.angular_distance_deg(
            q.astype(np.float64), np.asarray(wq, np.float64)) < 1e-4
    cost = float(state[lm.S_COST0])
    assert abs(cost - float(want[4])) <= 1e-5 * abs(float(want[4]))
    assert int(n_res) == int(want[5]) > 100
    # the problem moved the poses: the comparison is not of identities
    assert np.linalg.norm(np.asarray(want[3]) - np.asarray(pose[3])) > 1e-3


@pytest.mark.parametrize("pose_name", sorted(POSES))
def test_masked_loop_equals_early_exit_loop(pose_name):
    _statics, dyn, raw, alphas, prob, pose, prior = _problem(pose_name)
    a = _run_port(dyn, *_port_inputs(dyn, raw, alphas, prob, pose, prior)[:3],
                  torch.from_numpy(prior), early_exit=False)
    b = _run_port(dyn, *_port_inputs(dyn, raw, alphas, prob, pose, prior)[:3],
                  torch.from_numpy(prior), early_exit=True)
    assert torch.equal(a, b)
    assert a[lm.S_DONE] == 1


@pytest.mark.parametrize("pose_name", sorted(POSES))
def test_forward_mode_jacobian_equals_jacfwd(pose_name):
    _statics, dyn, raw, alphas, prob, pose, prior = _problem(pose_name)
    rows, state, n_res, tprior = _port_inputs(dyn, raw, alphas, prob, pose,
                                              prior)
    zero = torch.zeros(12)
    want = jacfwd(lambda d: lm.residual_vector(d, state, rows, tprior,
                                               n_res))(zero)
    lin = lm.residual_vector(dual.Dual.seed(zero), state, rows, tprior, n_res,
                             m=dual.math)
    torch.testing.assert_close(lin.jacobian(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(lin.v, lm.residual_vector(zero, state, rows, tprior,
                                                 n_res))
    assert want.shape == (rows.shape[0] + 10, 12)
    assert want[:, 0:6].abs().max() > 0 and want[:, 6:].abs().max() > 0


def test_solver_loop_runs_the_step_and_reads_nothing(monkeypatch):
    """solver._lm_inner_loop: one lm_loop call of min(ls_max_num_iters, 64)
    steps that stops at done, no host sync reported; the wrapper takes the
    plain version on the CPU and launches no kernel."""
    statics, dyn, raw, alphas, prob, pose, prior = _problem("moving")
    rows, state, n_res, tprior = _port_inputs(dyn, raw, alphas, prob, pose,
                                              prior)
    anchors, normals, _l, _c, geom_w, ok, _cls, _ = prob
    t = lambda x: torch.from_numpy(np.array(x))
    tdyn = tslv.unpack_dynamics(np.asarray(
        [np.asarray(getattr(dyn, f)) for f in dyn._fields], np.float32))
    tstat = tslv.SolverStatics(num_keypoints=raw.shape[0], max_neighbors=20,
                               level_index=0, voxel_neighborhood=2)
    calls = []
    loop = lm.lm_loop

    def count_calls(*args, **kwargs):
        calls.append(args[4])                     # n_steps
        return loop(*args, **kwargs)

    monkeypatch.setattr(lm, "lm_loop", count_calls)
    before = lm.launches
    steps_before = int(lm.steps_counter("cpu")[0])
    out = tslv._lm_inner_loop(tstat, tdyn, t(raw), t(alphas), t(anchors),
                              t(normals), t(geom_w), t(ok),
                              *(t(x) for x in pose), tprior)
    assert lm.launches == before and out[-1] == 0
    assert calls == [LS_STEPS]
    ref = _run_port(dyn, rows, state, n_res, tprior, early_exit=True)
    steps = int(lm.steps_counter("cpu")[0]) - steps_before
    assert 1 <= steps < LS_STEPS
    assert torch.equal(torch.cat(out[:4]), ref[0:14])
    assert torch.equal(out[4], ref[lm.S_COST0])
    with pytest.raises(ValueError):
        tslv._lm_inner_loop(tstat, tdyn._replace(ls_max_num_iters=0),
                            t(raw), t(alphas), t(anchors), t(normals),
                            t(geom_w), t(ok), *(t(x) for x in pose), tprior)
