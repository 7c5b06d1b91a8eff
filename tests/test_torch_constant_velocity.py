"""The CONSTANT_VELOCITY motion compensation of ct_icp_torch (CPU, plain
kernel versions) against ct_icp_tpu: ``pipeline.distort_raw`` on the same
points, poses and alphas (within 1e-5 m), and 8 frames of
tests/test_torch_staged.py's room drive registered by both packages on the
fused per-frame path (``register_frame``), the streamed path
(``stream_frames``, batch 4) and the staged path (ADAPTIVE keypoints):
success flags equal, end poses within 5 mm and 0.05 deg (float32 sums in
another order, as tests/test_torch_staged.py allows), and no host keypoint
prefix elected (the device bends the sub-frame before its election).

The fused per-frame run parts further from frame 3 on (the first frame
past the startup regimen: 0.57 mm there, up to 8.1 mm at frame 6), its
frames 0-2 within 1e-7 m: ``distort_raw``'s float32 rounding differs from
the reference's XLA program in one ulp on ~7 % of the coordinates, and
the wire format puts many points exactly on the sample grid's voxel faces
(multiples of 1/128 m), so a few of them (5 of 20,000 at 1 m voxels) land
in the neighbouring voxel in one package and the keypoint election differs
there. That run is held within 1e-5 m over frames 0-2 and within 1.2 cm
and 0.1 deg over all 8."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.odometry import pipeline as tpl
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.core import se3_np as s3n
from ct_icp_tpu.odometry import pipeline as jpl
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry
from test_torch_staged import (_staged, frames,  # noqa: F401
                               single_torch_thread)


def test_distort_raw_matches_reference():
    rng = np.random.default_rng(4)
    raw = rng.uniform(-30, 30, (4096, 3)).astype(np.float32)
    alphas = rng.uniform(0, 1, 4096).astype(np.float32)
    qb, qe = (s3n.quat_from_rotvec(rng.normal(scale=0.05, size=3))
              .astype(np.float32) for _ in range(2))
    tb, te = (rng.normal(size=3).astype(np.float32) for _ in range(2))
    want = jpl.distort_raw(*(jnp.asarray(a) for a in
                             (raw, alphas, qb, tb, qe, te)))
    got = tpl.distort_raw(*(torch.from_numpy(a) for a in
                            (raw, alphas, qb, tb, qe, te)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the points moved: the comparison is not of identities
    assert np.abs(got.numpy() - raw).max() > 0.1


def _cv(variant):
    o = _staged("adaptive" if variant == "staged" else "adaptive")
    if variant != "staged":
        o = dataclasses.replace(o, sampling=jopt.SamplingOption.GRID)
    return dataclasses.replace(
        o, motion_compensation=jopt.MotionCompensation.CONSTANT_VELOCITY)


def _close(jt, tt, d_tr=5e-3, d_rot=0.05):
    for a, b in zip(jt, tt):
        for p, q in ((a.begin_pose, b.begin_pose), (a.end_pose, b.end_pose)):
            assert np.linalg.norm(p.tr - q.tr) < d_tr
            assert s3n.angular_distance_deg(p.quat, q.quat) < d_rot


@pytest.mark.parametrize("variant", ["fused", "staged"])
def test_register_frame_matches_reference(variant, frames):
    jo = _cv(variant)
    jodo, todo = JOdometry(jo), TOdometry(options_from_dict(
        dataclasses.asdict(jo)), device="cpu")
    assert todo._use_fused == jodo._use_fused == (variant == "fused")
    js, ts_ = [], []
    for i, f in enumerate(frames):
        js.append(jodo.register_frame(f["xyz"], f["timestamps"], frame_id=i))
        ts_.append(todo.register_frame(f["xyz"], f["timestamps"],
                                       frame_id=i))
    assert [s.success for s in ts_] == [s.success for s in js]
    assert all(s.success for s in ts_)
    assert [s.sample_size for s in ts_[:4]] == [s.sample_size
                                                for s in js[:4]]
    if variant == "fused":
        _close(jodo.get_trajectory()[:3], todo.get_trajectory()[:3], 1e-5,
               1e-4)
        _close(jodo.get_trajectory(), todo.get_trajectory(), 1.2e-2, 0.1)
    else:
        _close(jodo.get_trajectory(), todo.get_trajectory())
    # the frames moved: the comparison is not of identities
    assert np.linalg.norm(todo.get_trajectory()[-1].end_pose.tr) > 0.3


def test_stream_frames_matches_reference(frames):
    jo = _cv("fused")
    jodo, todo = JOdometry(jo), TOdometry(options_from_dict(
        dataclasses.asdict(jo)), device="cpu")
    jp = [jodo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i,
                             upload=False) for i, f in enumerate(frames)]
    tp = [todo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
          for i, f in enumerate(frames)]
    # no host keypoint prefix: the device elects after the distortion
    assert all(p["kp_n"] == 0 for p in jp + tp)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a["scan_host"], b["scan_host"])
    js = list(jodo.stream_frames(iter(jp), batch=4))
    ts_ = list(todo.stream_frames(iter(tp), batch=4))
    assert [s.success for s in ts_] == [s.success for s in js]
    _close(jodo.get_trajectory(), todo.get_trajectory())
