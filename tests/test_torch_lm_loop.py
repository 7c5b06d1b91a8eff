"""The port's whole LM call, ``kernels/lm_step.py::lm_loop`` (one launch of
kernel K5 on the card; its plain version ``lm_loop_plain`` on the CPU),
against ct_icp_tpu's ``_lm_inner_loop`` (a ``lax.while_loop`` that stops at
``done``) on the ``__graft_entry__.entry()`` problem, for 1, 3 and 20 steps:
pose within 1e-5 m and 1e-4 deg, cost within 1e-5 relative. Also: the call
equals the early-exit loop of plain steps bit for bit, and adds the steps
it ran to the device's steps counter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.config.options import LeastSquares
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.kernels import lm_step as lm
from ct_icp_tpu.icp import solver as jslv
from test_torch_lm_step import POSES, _port_inputs, _problem


def _loop_args(dyn):
    return (LeastSquares.CAUCHY, np.float32(dyn.ls_sigma),
            np.float32(dyn.ls_tolerant_min_threshold), False)


def _early_exit_steps(dyn, rows, state, n_res, prior, n_steps):
    """Plain steps until done or ``n_steps``; returns the steps run."""
    steps = 0
    while steps < n_steps and state[lm.S_DONE] == 0:
        lm.lm_step_plain(rows, prior, n_res, state, *_loop_args(dyn))
        steps += 1
    return steps


@pytest.mark.parametrize("pose_name", sorted(POSES))
def test_lm_loop_equals_early_exit_loop(pose_name):
    _statics, dyn, raw, alphas, prob, pose, prior = _problem(pose_name)
    rows, state, n_res, tprior = _port_inputs(dyn, raw, alphas, prob, pose,
                                              prior)
    want = state.clone()
    want_steps = _early_exit_steps(dyn, rows, want, n_res, tprior, 20)
    counter = lm.steps_counter("cpu")
    before, launches = int(counter[0]), lm.launches
    lm.lm_loop(rows, tprior, n_res, state, 20, *_loop_args(dyn))
    assert torch.equal(state, want)
    # the loop stopped at done, before its last step
    assert state[lm.S_DONE] == 1 and 1 < want_steps < 20
    assert int(counter[0]) - before == want_steps
    assert lm.launches == launches              # the CPU launches nothing


@pytest.mark.parametrize("n_steps", [1, 3, 20])
@pytest.mark.parametrize("pose_name", sorted(POSES))
def test_lm_loop_matches_reference(pose_name, n_steps):
    statics, dyn, raw, alphas, prob, pose, prior = _problem(pose_name)
    dyn = dyn._replace(ls_max_num_iters=jnp.int32(n_steps))
    anchors, normals, lines, cov, geom_w, ok, cls, _ = prob
    want = jax.jit(lambda *a: jslv._lm_inner_loop(statics, dyn, *a))(
        raw, alphas, anchors, normals, lines, cov, geom_w, ok, cls, *pose,
        jslv.unpack_prior(jnp.asarray(prior)))
    rows, state, n_res, tprior = _port_inputs(dyn, raw, alphas, prob, pose,
                                              prior)
    plain = state.clone()
    plain_steps = lm.lm_loop_plain(rows, tprior, n_res, plain, n_steps,
                                   *_loop_args(dyn))
    counter = lm.steps_counter("cpu")
    before = int(counter[0])
    lm.lm_loop(rows, tprior, n_res, state, n_steps, *_loop_args(dyn))
    assert int(counter[0]) - before == plain_steps
    assert plain_steps == n_steps or state[lm.S_DONE] == 1
    for sl, (wq, wt) in ((slice(0, 7), (want[0], want[1])),
                         (slice(7, 14), (want[2], want[3]))):
        q, tr = state[sl][0:4].numpy(), state[sl][4:7].numpy()
        assert np.linalg.norm(tr - np.asarray(wt)) < 1e-5
        assert s3n.angular_distance_deg(
            q.astype(np.float64), np.asarray(wq, np.float64)) < 1e-4
    cost = float(state[lm.S_COST0])
    assert abs(cost - float(want[4])) <= 1e-5 * abs(float(want[4]))
    assert int(n_res) == int(want[5]) > 100
    # the call moved the pose: the comparison is not of identities
    assert np.linalg.norm(np.asarray(want[3]) - np.asarray(pose[3])) > 1e-4
