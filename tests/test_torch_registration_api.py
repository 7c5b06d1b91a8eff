"""``CTICPRegistration.register`` (numpy in, numpy out) of ct_icp_torch
(CPU, plain kernel versions) against ct_icp_tpu's on tests/test_solver.py's
room cases: the same map (carried across with
``convert.map_state_from_numpy``), scans, initial frames and priors.

Equal: ``success`` and ``num_residuals_used``. Poses within 5 mm and
0.05 deg (float32 sums in another order move the solver's iterates), the
streamed slice's tolerance; and both within the reference test's bounds
of the ground truth.
"""

import dataclasses

import numpy as np
import pytest

from ct_icp_torch.config import options as topt
from ct_icp_torch.convert import map_state_from_numpy, options_from_dict
from ct_icp_torch.core.pose import Pose as TPose
from ct_icp_torch.core.pose import TrajectoryFrame as TFrame
from ct_icp_torch.icp import registration as treg
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.core import se3_np as s3n
from ct_icp_tpu.core.pose import Pose, TrajectoryFrame
from ct_icp_tpu.icp.registration import CTICPRegistration, make_prior
from ct_icp_tpu.mapping import voxel_map as vm

from test_solver import MAP_OPTIONS, _gt_frame, make_room_map, render_scan


@pytest.fixture(scope="module")
def rooms():
    """The reference test's room map, in both packages."""
    jmap = make_room_map(np.random.default_rng(5), MAP_OPTIONS)
    tmap = map_state_from_numpy([lv._asdict() for lv in jmap.levels])
    return jmap, tmap


def _tframe(f: TrajectoryFrame) -> TFrame:
    return TFrame(*(TPose(p.quat.copy(), p.tr.copy(), timestamp=p.timestamp)
                    for p in (f.begin_pose, f.end_pose)))


def _both(jmap, tmap, opts, raw, ts, init, n_kp=1024, prior=None,
          tprior=None):
    """register() in both packages from copies of ``init``; returns the
    summaries and the registered frames."""
    jreg = CTICPRegistration(opts, MAP_OPTIONS, num_keypoints=n_kp)
    treg_ = treg.CTICPRegistration(
        options_from_dict(dataclasses.asdict(opts), topt.CTICPOptions),
        options_from_dict(dataclasses.asdict(MAP_OPTIONS),
                          topt.MultiResolutionVoxelMapOptions),
        num_keypoints=n_kp)
    jf, tf = init.copy(), _tframe(init)
    js = jreg.register(jmap, raw, ts, jf, prior=prior)
    ts_ = treg_.register(tmap, raw, ts, tf, prior=tprior, device="cpu")
    return js, ts_, jf, tf


def _close(a, b):
    for p, q in ((a.begin_pose, b.begin_pose), (a.end_pose, b.end_pose)):
        assert np.linalg.norm(p.tr - q.tr) < 5e-3
        assert s3n.angular_distance_deg(p.quat, q.quat) < 0.05


def _opts(**kw):
    return jopt.CTICPOptions(**{
        "num_iters_icp": 15, "ls_max_num_iters": 5,
        "threshold_orientation_norm": 1e-5,
        "threshold_translation_norm": 1e-6, "min_number_neighbors": 10,
        **kw})


def _init(rot_b, tr_b, rot_e, tr_e):
    return TrajectoryFrame(
        Pose(s3n.quat_from_rotvec(np.array([0, 0, np.deg2rad(rot_b)])),
             np.array(tr_b, float), timestamp=0.0),
        Pose(s3n.quat_from_rotvec(np.array([0, 0, np.deg2rad(rot_e)])),
             np.array(tr_e, float), timestamp=1.0))


@pytest.mark.parametrize("case", ["elastic", "simple", "prior"])
def test_register_matches_reference(rooms, case):
    jmap, tmap = rooms
    gt = _gt_frame()
    jprior = tprior = None
    if case == "elastic":
        raw, ts = render_scan(np.random.default_rng(9), 800, gt)
        opts = _opts()
        init = _init(0.5, [0.05, -0.05, 0.02], 1.0, [0.2, 0.2, -0.03])
    elif case == "simple":
        # a rigid frame: SIMPLE optimizes the end pose only (alphas all 1)
        pose = Pose(s3n.quat_from_rotvec(np.array([0.0, 0.0,
                                                   np.deg2rad(1.0)])),
                    np.array([0.2, 0.0, 0.0]), timestamp=1.0)
        gt = TrajectoryFrame(Pose(pose.quat.copy(), pose.tr.copy(),
                                  timestamp=0.0), pose)
        raw, ts = render_scan(np.random.default_rng(13), 600, gt)
        opts = _opts(num_iters_icp=12, ls_max_num_iters=4,
                     parametrization=jopt.PoseParametrization.SIMPLE)
        init = TrajectoryFrame(Pose(timestamp=0.0), Pose(timestamp=1.0))
    else:
        raw, ts = render_scan(np.random.default_rng(21), 700, gt)
        prev = TrajectoryFrame(Pose(timestamp=-1.0),
                               Pose(tr=np.zeros(3), timestamp=0.0))
        jprior = make_prior(prev, jopt.MotionModelOptions(), np.zeros(3))
        tprior = treg.make_prior(_tframe(prev), topt.MotionModelOptions(),
                                 np.zeros(3))
        np.testing.assert_array_equal(tprior, jprior)
        opts = _opts()
        init = TrajectoryFrame(Pose(timestamp=0.0), Pose(timestamp=1.0))
    js, ts_, jf, tf = _both(jmap, tmap, opts, raw, ts, init, prior=jprior,
                            tprior=tprior)
    assert ts_.success == js.success is True
    assert ts_.num_residuals_used == js.num_residuals_used > 400
    assert ts_.num_iters > 1 and ts_.duration_total > 0.0
    _close(tf, jf)
    # both near the ground truth (the reference test's bounds)
    assert np.linalg.norm(tf.end_pose.tr - gt.end_pose.tr) < 0.03
    assert tf.end_pose.angular_distance(gt.end_pose) < 0.15


def test_register_fails_on_an_empty_map():
    empty = vm.MapState(levels=(vm.make_level(10, 8),))
    tmap = map_state_from_numpy([lv._asdict() for lv in empty.levels])
    raw = np.random.default_rng(3).uniform(-1, 1, (100, 3))
    init = TrajectoryFrame(Pose(timestamp=0.0), Pose(timestamp=1.0))
    js, ts_, jf, tf = _both(empty, tmap,
                            jopt.CTICPOptions(min_number_neighbors=10), raw,
                            np.linspace(0, 1, 100), init, n_kp=128)
    assert ts_.success == js.success is False
    assert ts_.num_residuals_used == js.num_residuals_used
    assert ts_.error_log == js.error_log
    _close(tf, jf)
    with pytest.raises(ValueError, match="static capacity"):
        _both(empty, tmap, jopt.CTICPOptions(), raw, np.linspace(0, 1, 100),
              init, n_kp=64)
