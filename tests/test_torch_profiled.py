"""``profile_registration`` in ct_icp_torch (CPU, plain kernel versions),
held as the reference's own tests hold it (tests/test_round2.py:110-160)
and against ct_icp_tpu's profiled run on the same frames: over
tests/test_torch_staged.py's room drive, on the fused per-frame path and
on the staged path (ADAPTIVE keypoints), the ICPSummary durations are
positive, every key the reference's profiled run logs is logged, the
committed trajectory equals a non-profiled run's bit for bit and lies
within tests/test_torch_staged.py's bounds of the reference's profiled
trajectory (5 mm, 0.05 deg: float32 sums in another order), and (fused)
the replay of the solver on the frame step's inputs lands within 1e-3 m
of the committed poses (the same kernels: 0 here)."""

import dataclasses

import numpy as np
import pytest

from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry
from test_torch_staged import (_staged, frames,  # noqa: F401
                               single_torch_thread)


def _jax_opts(variant, profile):
    o = _staged("adaptive")
    if variant == "fused":
        o = dataclasses.replace(o, sampling=jopt.SamplingOption.GRID)
    return dataclasses.replace(o, profile_registration=profile)


def _opts(variant, profile):
    return options_from_dict(dataclasses.asdict(_jax_opts(variant, profile)))


@pytest.mark.parametrize("variant", ["fused", "staged"])
def test_profiled_registration(variant, frames):
    plain = TOdometry(_opts(variant, False), device="cpu")
    prof = TOdometry(_opts(variant, True), device="cpu")
    ref = JOdometry(_jax_opts(variant, True))
    assert prof._use_fused == (variant == "fused") == ref._use_fused
    summaries, ref_summaries = [], []
    for i, f in enumerate(frames[:5]):
        plain.register_frame(f["xyz"], f["timestamps"], frame_id=i)
        summaries.append(prof.register_frame(f["xyz"], f["timestamps"],
                                             frame_id=i))
        ref_summaries.append(ref.register_frame(f["xyz"], f["timestamps"],
                                                frame_id=i))
    # the committed trajectory is the non-profiled run's, bit for bit
    for a, b in zip(plain.get_trajectory(), prof.get_trajectory()):
        for p, q in ((a.begin_pose, b.begin_pose), (a.end_pose, b.end_pose)):
            assert np.array_equal(p.tr, q.tr)
            assert np.array_equal(p.quat, q.quat)
    # the reference's profiled trajectory, within test_torch_staged's bounds
    for a, b in zip(prof.trajectory, ref.trajectory):
        for p, q in ((a.begin_pose, b.begin_pose), (a.end_pose, b.end_pose)):
            assert p.location_distance(q) < 5e-3
            assert p.angular_distance(q) < 0.05
    for s, r in zip(summaries[1:], ref_summaries[1:]):
        icp = s.icp_summary
        assert s.success and icp.num_iters >= 1
        assert icp.duration_init > 0.0
        assert icp.avg_duration_neighborhood > 0.0
        assert icp.avg_duration_solve > 0.0
        assert icp.avg_duration_iter > 0.0
        assert icp.duration_total >= icp.avg_duration_iter * icp.num_iters
        # every key the reference's profiled frame logs
        assert "icp_duration_solve" in r.logged_values
        assert set(r.logged_values) <= set(s.logged_values), \
            set(r.logged_values) - set(s.logged_values)
        assert s.logged_values["icp_duration_solve"] > 0.0
        if variant == "fused":
            assert s.logged_values["profile_replay_pose_diff_m"] < 1e-3
            assert s.logged_values["profile_replay_num_iters"] == \
                icp.num_iters
