"""``CTICPRegistration.register`` of ct_icp_torch (CPU, plain kernel
versions) against ct_icp_tpu's for the solvers and distances beyond the
CERES point-to-plane path, on tests/test_solver.py's room (the same map,
scans, initial frames and priors as the reference's own tests): the GN
solver, the ROBUST solver (the distribution on and off, lines off with the
barycenter), point-to-point, point-to-line and point-to-distribution, the
analytic Jacobian and a [41] prediction-consistency prior. Equal:
``success`` and ``num_residuals_used``; poses within 1e-4 m and 1e-3 deg,
and near the ground truth as the reference tests hold it.

Point-to-point, -line and -distribution part further: the LM calls agree
within 1e-5 m on identical problems (tests/test_torch_lm_families.py), so
the parting is the association's float32 sums (K2's moments in another
order), and the reference itself moves as far from a nudge of its initial
end translation by 1-2 um (point up to 1.0 mm, line 11 mm: a planar
neighbourhood's in-plane line is set by rounding, distribution 0.35 mm).
They are held within twice the reference's own spread over four such
nudges, measured in the test. Also the reference's ValueErrors,
``PredictionConsistencyModel`` against the reference's, and
``debug_problem``'s arrays against the reference's."""

import dataclasses

import numpy as np
import pytest

from ct_icp_torch.config import options as topt
from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.icp import registration as treg
from ct_icp_torch.icp import solver as tslv
from ct_icp_torch.odometry import motion_model as tmm
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.core import se3_np as s3n
from ct_icp_tpu.core.pose import Pose, TrajectoryFrame
from ct_icp_tpu.icp.registration import CTICPRegistration
from ct_icp_tpu.odometry import motion_model as jmm

from test_solver import MAP_OPTIONS, _gt_frame, render_scan
from test_torch_registration_api import _opts, _tframe, rooms  # noqa: F401
from test_torch_staged import single_torch_thread  # noqa: F401

# case -> (options, scan seed, points, initial frame kind)
CASES = {
    "gn": (dict(num_iters_icp=20, ls_max_num_iters=1,
                solver=jopt.Solver.GN, max_dist_to_plane_ct_icp=1.0), 41,
           800, "identity"),
    "robust": (dict(solver=jopt.Solver.ROBUST), 31, 800, "identity"),
    "robust_point": (dict(solver=jopt.Solver.ROBUST, use_distribution=False),
                     31, 800, "identity"),
    "robust_barycenter": (dict(solver=jopt.Solver.ROBUST, use_lines=False,
                               use_barycenter=True), 31, 800, "identity"),
    "point": (dict(distance=jopt.IcpDistance.POINT_TO_POINT), 51, 800,
              "identity"),
    "line": (dict(distance=jopt.IcpDistance.POINT_TO_LINE), 51, 800,
             "identity"),
    "distribution": (dict(distance=jopt.IcpDistance.POINT_TO_DISTRIBUTION),
                     51, 800, "identity"),
    "analytic": (dict(analytic_jacobian=True), 9, 800, "elastic"),
    "huber": (dict(loss_function=jopt.LeastSquares.HUBER), 9, 800,
              "elastic"),
}
# poses: (m, deg); None: twice the reference's own spread under nudges
BOUNDS = {case: (1e-4, 1e-3) for case in CASES}
BOUNDS["prior41"] = (1e-4, 1e-3)
for _case in ("point", "line", "distribution"):
    BOUNDS[_case] = None
NUDGES_M = (1e-6, -1e-6, 2e-6, -2e-6)
# the reference tests' bounds of the ground truth: end translation (m)
GT_BOUND = {"distribution": 0.05, "line": 0.05, "point": 0.05}


def _init(kind):
    if kind == "identity":
        return TrajectoryFrame(Pose(timestamp=0.0), Pose(timestamp=1.0))
    return TrajectoryFrame(
        Pose(s3n.quat_from_rotvec(np.array([0, 0, np.deg2rad(0.5)])),
             np.array([0.05, -0.05, 0.02]), timestamp=0.0),
        Pose(s3n.quat_from_rotvec(np.array([0, 0, np.deg2rad(1.0)])),
             np.array([0.2, 0.2, -0.03]), timestamp=1.0))


def _regs(opts):
    jreg = CTICPRegistration(opts, MAP_OPTIONS, num_keypoints=1024)
    treg_ = treg.CTICPRegistration(
        options_from_dict(dataclasses.asdict(opts), topt.CTICPOptions),
        options_from_dict(dataclasses.asdict(MAP_OPTIONS),
                          topt.MultiResolutionVoxelMapOptions),
        num_keypoints=1024)
    return jreg, treg_


def _register(rooms, opts, raw, ts, init, prior=None):
    jmap, tmap = rooms
    jreg, treg_ = _regs(opts)
    jf, tf = init.copy(), _tframe(init)
    js = jreg.register(jmap, raw, ts, jf, prior=prior)
    ts_ = treg_.register(tmap, raw, ts, tf, prior=prior, device="cpu")
    return js, ts_, jf, tf


def _gaps(a, b):
    return (max(np.linalg.norm(a.begin_pose.tr - b.begin_pose.tr),
                np.linalg.norm(a.end_pose.tr - b.end_pose.tr)),
            max(s3n.angular_distance_deg(a.begin_pose.quat, b.begin_pose.quat),
                s3n.angular_distance_deg(a.end_pose.quat, b.end_pose.quat)))


def _reference_spread(rooms, opts, raw, ts, init, jf):
    """The reference's largest pose gap to its own result ``jf`` when its
    initial end translation moves by NUDGES_M along x."""
    jreg, _ = _regs(opts)
    gaps = []
    for nudge in NUDGES_M:
        f = init.copy()
        f.end_pose.tr = f.end_pose.tr + np.array([nudge, 0.0, 0.0])
        jreg.register(rooms[0], raw, ts, f)
        gaps.append(_gaps(f, jf))
    return tuple(max(g[i] for g in gaps) for i in range(2))


def _hold(case, js, ts_, jf, tf, bounds=None):
    assert ts_.success == js.success is True
    assert ts_.num_residuals_used == js.num_residuals_used > 300
    d_tr, d_rot = bounds or BOUNDS[case]
    for p, q in ((tf.begin_pose, jf.begin_pose), (tf.end_pose, jf.end_pose)):
        assert np.linalg.norm(p.tr - q.tr) < d_tr, (case, p.tr - q.tr)
        assert s3n.angular_distance_deg(p.quat, q.quat) < d_rot
    gt = _gt_frame()
    assert np.linalg.norm(tf.end_pose.tr - gt.end_pose.tr) \
        < GT_BOUND.get(case, 0.03)


@pytest.mark.parametrize("case", sorted(CASES))
def test_register_matches_reference(rooms, case):
    kw, seed, n, kind = CASES[case]
    raw, ts = render_scan(np.random.default_rng(seed), n, _gt_frame())
    js, ts_, jf, tf = _register(rooms, _opts(**kw), raw, ts, _init(kind))
    bounds = None
    if BOUNDS[case] is None:
        spread = _reference_spread(rooms, _opts(**kw), raw, ts, _init(kind),
                                   jf)
        bounds = (max(1e-4, 2.0 * spread[0]), max(1e-3, 2.0 * spread[1]))
    _hold(case, js, ts_, jf, tf, bounds)


def _prediction_models(options=None):
    kw = options or dict(alpha_begin_tr_constraint=1.0,
                         alpha_begin_rot_constraint=1.0)
    jm = jmm.PredictionConsistencyModel(
        jmm.PredictionConsistencyOptions(**kw))
    tm = tmm.PredictionConsistencyModel(
        tmm.PredictionConsistencyOptions(**kw))
    return jm, tm


def test_register_with_prediction_prior_matches_reference(rooms):
    """The reference test's [41] prior: a prediction at the ground truth
    with the begin-pose constraints on."""
    raw, ts = render_scan(np.random.default_rng(33), 700, _gt_frame())
    jm, tm = _prediction_models()
    gt = _gt_frame()
    jm.set_prediction(gt.copy())
    tm.set_prediction(_tframe(gt))
    prior = jm.device_prior(np.zeros(3))
    np.testing.assert_array_equal(tm.device_prior(np.zeros(3)), prior)
    js, ts_, jf, tf = _register(rooms, _opts(), raw, ts,
                                _init("identity"), prior=prior)
    _hold("prior41", js, ts_, jf, tf)
    assert tm.is_valid(tf) == jm.is_valid(jf) is True


@pytest.mark.parametrize("model", [7, 1, 2, 4, 0])
def test_prediction_model_matches_reference(model):
    """device_prior (bit for bit) and is_valid of both packages, for each
    constraint type, from the same prediction and an origin."""
    rng = np.random.default_rng(model + 3)
    kw = dict(model=model, alpha_begin_tr_constraint=3.0,
              alpha_begin_rot_constraint=2.0, alpha_end_tr_constraint=5.0,
              alpha_end_rot_constraint=4.0)
    jm, tm = _prediction_models(kw)
    pred = TrajectoryFrame(
        Pose(s3n.quat_from_rotvec(rng.normal(scale=0.1, size=3)),
             rng.normal(size=3), timestamp=0.0),
        Pose(s3n.quat_from_rotvec(rng.normal(scale=0.1, size=3)),
             rng.normal(size=3), timestamp=1.0))
    jm.set_prediction(pred)
    tm.set_prediction(_tframe(pred))
    origin = rng.normal(size=3)
    np.testing.assert_array_equal(tm.device_prior(origin),
                                  jm.device_prior(origin))
    for shift in (0.0, 0.3, 2.0):
        frame = pred.copy()
        frame.end_pose.tr = frame.end_pose.tr + shift
        assert tm.is_valid(_tframe(frame)) == jm.is_valid(frame)
    assert tm.next_frame().end_pose.location_distance(
        _tframe(pred).end_pose) == 0.0


def test_reference_value_errors():
    """What the reference rejects (solver.py:687-702), with its messages."""
    base = tslv.SolverStatics(num_keypoints=64, max_neighbors=4,
                              level_index=0, voxel_neighborhood=1,
                              num_closest_neighbors=2,
                              ball_neighborhood=False)
    with pytest.raises(ValueError, match="sorted neighbor list"):
        tslv.build_register_fn(dataclasses.replace(base,
                                                   ball_neighborhood=True))
    for solver in (topt.Solver.GN, topt.Solver.ROBUST):
        with pytest.raises(ValueError, match="CERES-builder"):
            tslv.build_register_fn(dataclasses.replace(base, solver=solver))
    with pytest.raises(ValueError, match="exceeds max_number_neighbors"):
        tslv.build_register_fn(dataclasses.replace(base, max_neighbors=1))
    # every solver, distance, loss and Jacobian branch builds
    for solver in topt.Solver:
        for distance in topt.IcpDistance:
            tslv.build_register_fn(dataclasses.replace(
                base, num_closest_neighbors=1, ball_neighborhood=True,
                solver=solver, distance=distance, analytic_jacobian=True))


@pytest.mark.parametrize("case", ["plane", "robust", "distribution"])
def test_debug_problem_matches_reference(rooms, case):
    """The OutputBuilder arrays at the ground truth: equal masks and
    classes, the points and residuals within 1e-4, the weights within 1e-3
    (K2's a2D tolerance: the moments are summed in another order), the
    normals and lines along the reference's."""
    jmap, tmap = rooms
    kw = {"plane": {}, "robust": dict(solver=jopt.Solver.ROBUST),
          "distribution": dict(
              distance=jopt.IcpDistance.POINT_TO_DISTRIBUTION)}[case]
    raw, ts = render_scan(np.random.default_rng(41), 500, _gt_frame())
    jreg, treg_ = _regs(_opts(**kw))
    gt = _gt_frame()
    want = jreg.debug_problem(jmap, raw, ts, gt.copy())
    got = treg_.debug_problem(tmap, raw, ts, _tframe(gt), device="cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["ok"], want["ok"])
    ok = want["ok"]
    assert ok.sum() > 300
    if case == "robust":
        np.testing.assert_array_equal(got["classification"],
                                      want["classification"])
    else:
        assert got["classification"].shape == want["classification"].shape
    for key, tol in (("world", 1e-4), ("anchors", 1e-4),
                     ("residuals", 1e-4), ("weights", 1e-3)):
        np.testing.assert_allclose(got[key][ok], want[key][ok], rtol=tol,
                                   atol=tol)
    for key in ("normals", "lines"):
        # eigenvectors: the same up to sign where the eigenvalue is apart
        cos = np.abs(np.sum(got[key][ok] * want[key][ok], axis=-1))
        assert np.median(cos) > 1.0 - 1e-5
