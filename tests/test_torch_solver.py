"""Parity of ct_icp_torch's CT-ICP solver with ct_icp_tpu's on the
``__graft_entry__.entry()`` problem (CPU; the port through its plain kernel
versions): poses within 1e-4 m and 1e-3 deg, equal iteration counts. Also
the host motion model that feeds the solver its prior."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from ct_icp_torch.config import options as topt
from ct_icp_torch.convert import map_state_from_numpy
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.pose import Pose as TPose
from ct_icp_torch.core.pose import TrajectoryFrame as TFrame
from ct_icp_torch.icp import solver as tslv
from ct_icp_torch.odometry.motion_model import \
    PreviousFrameMotionModel as TModel
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.core.pose import Pose as JPose
from ct_icp_tpu.core.pose import TrajectoryFrame as JFrame
from ct_icp_tpu.odometry.motion_model import \
    PreviousFrameMotionModel as JModel


def test_register_matches_reference():
    fn, args = __graft_entry__.entry()
    level, raw, alphas, valid, qb, tb, qe, te, prior, dyn = args
    want = jax.jit(fn)(*args)

    statics = tslv.SolverStatics(num_keypoints=raw.shape[0], max_neighbors=20,
                                 level_index=0, voxel_neighborhood=2)
    register = tslv.build_register_fn(statics)
    tlevel = map_state_from_numpy([level._asdict()])[0]
    packed = np.asarray([np.asarray(getattr(dyn, f)) for f in dyn._fields],
                        np.float32)
    t = lambda x: torch.from_numpy(np.array(x))
    got = register(tlevel, t(raw), t(alphas), t(valid), t(qb), t(tb), t(qe),
                   t(te), t(prior), packed)

    assert got.num_iters == int(want.num_iters) > 1
    assert got.valid_problem == bool(want.valid_problem)
    assert int(got.num_residuals) == int(want.num_residuals)
    for gq, gt, wq, wt in ((got.quat_begin, got.tr_begin, want.quat_begin,
                            want.tr_begin),
                           (got.quat_end, got.tr_end, want.quat_end,
                            want.tr_end)):
        assert np.linalg.norm(gt.numpy() - np.asarray(wt)) < 1e-4
        ang = s3n.angular_distance_deg(gq.numpy().astype(np.float64),
                                       np.asarray(wq).astype(np.float64))
        assert ang < 1e-3
    # the problem moved the poses: the comparison is not of identities
    assert np.linalg.norm(np.asarray(want.tr_end)) > 1e-3


@pytest.mark.parametrize("model", ["CONSTANT_VELOCITY", "SMALL_VELOCITY"])
def test_motion_model_matches_reference(model):
    """PreviousFrameMotionModel (prediction, validity, packed prior) of
    both packages from the same previous frame: equal within 1e-12 (the
    same float64 numpy arithmetic) and the packed prior bit-identical."""
    rng = np.random.default_rng(7)
    q0, q1 = (s3n.quat_normalize(rng.normal(size=4) + [4.0, 0, 0, 0])
              for _ in range(2))
    t0, t1 = rng.normal(size=3), rng.normal(size=3)
    origin = rng.normal(size=3)
    kw = dict(model=model, beta_small_velocity=0.01,
              beta_orientation_consistency=0.02)
    models = []
    for pose, frame, mopt, model_cls in (
            (JPose, JFrame, jopt, JModel), (TPose, TFrame, topt, TModel)):
        mm = model_cls(mopt.MotionModelOptions(
            **{**kw, "model": mopt.MotionModelType(model)}))
        mm.update_state(frame(pose(q0, t0, timestamp=1.0),
                              pose(q1, t1, timestamp=1.1)), 1)
        models.append(mm)
    jm, tm = models
    jn, tn = jm.next_frame(), tm.next_frame()
    for a, b in ((jn.begin_pose, tn.begin_pose), (jn.end_pose, tn.end_pose)):
        np.testing.assert_allclose(b.quat, a.quat, atol=1e-12)
        np.testing.assert_allclose(b.tr, a.tr, atol=1e-12)
        assert b.timestamp == a.timestamp
    assert tm.is_valid(tn) == jm.is_valid(jn) is True
    assert tm.is_valid(tm.previous_frame) == jm.is_valid(jm.previous_frame)
    np.testing.assert_array_equal(tm.device_prior(origin),
                                  jm.device_prior(origin))
