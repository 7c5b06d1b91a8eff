"""Kernel K5's plain version (``kernels/lm_step.py::lm_loop`` on the CPU)
against ct_icp_tpu's ``_lm_inner_loop`` on identical problems: the
``__graft_entry__.entry()`` map and keypoints at a moving initial pose,
associated by ct_icp_tpu's ``_build_problem`` for each solver statics, and
the rows packed from its arrays. Every residual family (point-to-plane,
-point, -line, -distribution, the ROBUST solver's mixed rows with and
without the distribution), each loss on point-to-plane, the [41] prior
with its prediction block, and the analytic Jacobian of each distance: 20
steps at most, poses within 1e-5 m and 1e-4 deg, the cost within 1e-5
relative.

Two calls part at a float32 tie, after the problem's cost has stopped
moving: TOLERANT (its cost is mostly the rho(0) of the ~560 masked rows,
which both packages sum in their own order, 3 ulps apart; at step 3 the
port accepts a trial 2 ulps below its cost that the reference, 3 ulps
lower already, rejects) and the analytic point-to-point Jacobian (after 11
rejected steps the port accepts a trial 2 ulps down at step 17, the
reference one step later; where the tie falls moves with the order of the
float32 sums, e.g. with the BLAS thread count). Each is held within 1e-5
m while its cost still falls by many ulps a step (2 and 5 steps), and
over 20 steps within 5e-5 m and 5e-4 deg
(one more step accepted: 2.5e-5 m, 3.8e-4 and 1.8e-4 deg) with the costs
within 1e-6 relative (a few ulps)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.config import options as topt
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.kernels import lm_step as lm
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.icp import solver as jslv
from test_torch_lm_step import POSES, _problem
from test_torch_residual_families import _prior41
from test_torch_staged import single_torch_thread  # noqa: F401

LOSSES = ["STANDARD", "CAUCHY", "HUBER", "TOLERANT", "TRUNCATED"]
DISTANCES = ["POINT_TO_PLANE", "POINT_TO_POINT", "POINT_TO_LINE",
             "POINT_TO_DISTRIBUTION"]


def _case(distance="POINT_TO_PLANE", solver="CERES", loss="CAUCHY",
          prior41=False, analytic=False, use_distribution=True, steps=None):
    """Both packages' LM call on the entry problem with these statics;
    returns (the reference's (qb, tb, qe, te, cost, n_res), the port's
    state, the port's steps)."""
    base, dyn, raw, alphas, _prob, pose, prior = _problem("moving")
    if steps is not None:
        dyn = dyn._replace(ls_max_num_iters=jnp.int32(steps))
    statics = dataclasses.replace(
        base, distance=getattr(jopt.IcpDistance, distance),
        solver=getattr(jopt.Solver, solver),
        loss=getattr(jopt.LeastSquares, loss), analytic_jacobian=analytic,
        use_distribution=use_distribution)
    fn, args = __import__("__graft_entry__").entry()
    level, valid = args[0], args[3]
    prob = jslv._build_problem(statics, dyn, level, raw, alphas, valid,
                               *pose, pose[3])
    if prior41:
        p41 = _prior41()
        p41[:14] = prior
        prior = p41
    anchors, normals, lines, cov, geom_w, ok, cls, _ = prob
    want = jax.jit(lambda *a: jslv._lm_inner_loop(statics, dyn, *a))(
        raw, alphas, anchors, normals, lines, cov, geom_w, ok, cls, *pose,
        jslv.unpack_prior(jnp.asarray(prior)))
    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    family = lm.family_of(getattr(topt.Solver, solver),
                          getattr(topt.IcpDistance, distance))
    rows = lm.pack_rows(t(raw), t(alphas), t(anchors), t(normals),
                        t(geom_w), t(ok), family, t(lines), t(cov), t(cls))
    state = lm.init_state(*(t(x) for x in pose))
    n_res = t(ok).sum(dtype=torch.int32)
    steps = lm.lm_loop_plain(
        rows, t(prior), n_res, state, int(dyn.ls_max_num_iters),
        getattr(topt.LeastSquares, loss), np.float32(dyn.ls_sigma),
        np.float32(dyn.ls_tolerant_min_threshold), False, family,
        use_distribution, analytic and solver != "ROBUST")
    assert int(n_res) == int(want[5]) > 100
    return want, state, steps, pose


def _check(want, state, pose, d_tr=1e-5, d_cost=1e-5, d_rot=1e-4):
    for sl, (wq, wt) in ((slice(0, 7), (want[0], want[1])),
                         (slice(7, 14), (want[2], want[3]))):
        q, tr = state[sl][0:4].numpy(), state[sl][4:7].numpy()
        assert np.linalg.norm(tr - np.asarray(wt)) < d_tr
        assert s3n.angular_distance_deg(
            q.astype(np.float64), np.asarray(wq, np.float64)) < d_rot
    cost = float(state[lm.S_COST0])
    assert abs(cost - float(want[4])) <= d_cost * abs(float(want[4]))
    # the call moved the pose: the comparison is not of identities
    assert np.linalg.norm(np.asarray(want[3]) - np.asarray(pose[3])) > 1e-4


@pytest.mark.parametrize("distance", DISTANCES)
def test_family_matches_reference(distance):
    want, state, steps, pose = _case(distance=distance)
    _check(want, state, pose)
    assert steps >= 1


@pytest.mark.parametrize("use_distribution", [True, False])
def test_robust_rows_match_reference(use_distribution):
    want, state, _, pose = _case(solver="ROBUST",
                                 use_distribution=use_distribution)
    _check(want, state, pose)


def _tie_checked(before_tie, **kw):
    """A call that parts at a float32 tie (see the module docstring):
    strict over its first ``before_tie`` steps, the stated bound over 20."""
    want, state, _, pose = _case(steps=before_tie, **kw)
    _check(want, state, pose)
    want, state, _, pose = _case(**kw)
    _check(want, state, pose, d_tr=5e-5, d_cost=1e-6, d_rot=5e-4)


@pytest.mark.parametrize("loss", LOSSES)
def test_loss_matches_reference(loss):
    if loss == "TOLERANT":
        _tie_checked(2, loss=loss)
        return
    want, state, _, pose = _case(loss=loss)
    _check(want, state, pose)


@pytest.mark.parametrize("distance", ["POINT_TO_PLANE",
                                      "POINT_TO_DISTRIBUTION"])
def test_prior41_matches_reference(distance):
    want, state, _, pose = _case(distance=distance, prior41=True)
    _check(want, state, pose)


@pytest.mark.parametrize("distance", DISTANCES)
def test_analytic_matches_reference(distance):
    if distance == "POINT_TO_POINT":
        _tie_checked(5, distance=distance, analytic=True)
        return
    want, state, _, pose = _case(distance=distance, analytic=True)
    _check(want, state, pose)


def test_analytic_is_not_for_robust_rows():
    rows = torch.zeros((4, lm.ROW_WIDTH[lm.Family.ROBUST]))
    with pytest.raises(ValueError, match="ROBUST"):
        lm.lm_loop(rows, torch.zeros(14), torch.zeros((), dtype=torch.int32),
                   lm.init_state(*(torch.tensor(x, dtype=torch.float32)
                                   for x in POSES["identity"])), 1,
                   topt.LeastSquares.CAUCHY, 0.1, 0.05, False,
                   family=lm.Family.ROBUST, analytic=True)
