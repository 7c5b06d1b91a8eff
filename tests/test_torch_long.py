"""The host modules of the port's long urban drive against ct_icp_tpu's and
PyYAML's (CPU): the YAML reader, the city-block scene, the waypoint drive,
frames of the 500-frame drive, the KITTI metrics, the prefetch iterator and
the gate constants of ``ct_icp_torch/tools/bench.py``.
"""

import pathlib
import threading
import time

import numpy as np
import pytest
import yaml

import bench
from ct_icp_torch.config import yaml_config as tyc
from ct_icp_torch.core.pose import Pose as TPose
from ct_icp_torch.datasets import long_drive as ld
from ct_icp_torch.datasets import synthetic as tsyn
from ct_icp_torch.evaluation import kitti as tkitti
from ct_icp_torch.odometry.concurrent import PrefetchIterator
from ct_icp_tpu.config import yaml_config as jyc
from ct_icp_tpu.core.pose import Pose as JPose
from ct_icp_tpu.datasets import synthetic as jsyn
from ct_icp_tpu.evaluation import kitti as jkitti

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCENE_FILES = sorted(ROOT.glob("configs/synthetic_*.yaml"))


@pytest.mark.parametrize("path", SCENE_FILES, ids=lambda p: p.name)
def test_yaml_reader_matches_safe_load(path):
    text = path.read_text()
    assert tyc.load_yaml(text) == yaml.safe_load(text)


def test_yaml_reader_scalars_match_safe_load():
    text = """# a comment
a: 1
b: -2.5e+3
c: [1, [2.0, 3], 'x y', "q#r"]   # trailing comment
d:
- k: true
  l: off
  m: ~
- 7
e:
  f: .5
  g: null
  h: plain text
  i: [[0.0, 1.0],
      [2.0, 3.0]]
j: 1e-3
k: .inf
"""
    assert tyc.load_yaml(text) == yaml.safe_load(text)


def _same_prims(tp, jp):
    assert len(tp) == len(jp) > 0
    for a, b in zip(tp, jp):
        assert type(a).__name__ == type(b).__name__
        for f in ("a", "b", "c", "center", "radius"):
            if hasattr(b, f):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_city_blocks_and_drive_match_reference():
    _same_prims(tsyn.city_blocks(nx=5, ny=3, seed=3),
                jsyn.city_blocks(nx=5, ny=3, seed=3))
    node = yaml.safe_load(ld.config_path().read_text())["trajectory"]
    kw = dict(speed_profile=node["speed_profile"], height=node["height"],
              corner_radius=node["corner_radius"],
              max_accel=node["max_accel"])
    tt = tsyn.waypoint_drive_trajectory(node["waypoints"], **kw)
    jt = jsyn.waypoint_drive_trajectory(node["waypoints"], **kw)
    assert len(tt.poses) == len(jt.poses) > 500
    for p, q in zip(tt.poses, jt.poses):
        np.testing.assert_array_equal(p.quat, q.quat)
        np.testing.assert_array_equal(p.tr, q.tr)
        assert p.timestamp == q.timestamp
    # the handheld sway and the yaw-rate cap of the indoor walk
    kw = dict(sway_deg=2.5, bob_amp=0.03, max_yaw_rate_dps=50.0,
              corner_radius=1.2, pose_rate=40.0)
    wps = [[1.0, 1.1], [3.2, 1.1], [3.2, -1.6], [2.2, -3.0]]
    for p, q in zip(tsyn.waypoint_drive_trajectory(wps, **kw).poses,
                    jsyn.waypoint_drive_trajectory(wps, **kw).poses):
        np.testing.assert_array_equal(p.quat, q.quat)
        np.testing.assert_array_equal(p.tr, q.tr)


def test_long_drive_frames_match_reference():
    """Three frames of configs/synthetic_long_drive.yaml, read by each
    package's own loader, cut to 2,000 points a frame: bit for bit."""
    tacq = ld.load_acquisition(ld.LONG_SEEDS[0])
    jacq = jyc.synthetic_sequence_from_yaml(str(ld.config_path()),
                                            seed=ld.LONG_SEEDS[0]).acq
    assert tacq.num_frames() == jacq.num_frames() >= ld.LONG_FRAMES
    assert tacq.options.num_points_per_frame == 100_000
    for acq in (tacq, jacq):
        acq.options.num_points_per_frame = 2000
    for i in (0, 1, 300):
        a, b = tacq.frame(i), jacq.frame(i)
        assert a["xyz"].shape == (2000, 3)
        np.testing.assert_array_equal(a["xyz"], b["xyz"])
        np.testing.assert_array_equal(a["timestamps"], b["timestamps"])
        for key in ("begin_pose", "end_pose"):
            np.testing.assert_array_equal(a[key].tr, b[key].tr)
            np.testing.assert_array_equal(a[key].quat, b[key].quat)


def test_evaluate_poses_matches_reference():
    """A ~380 m ground truth (the long drive's poses every 0.1 s) and an
    estimate that drifts and jitters: every metric equal."""
    traj = tyc.synthetic_sequence_from_yaml(str(ld.config_path())).trajectory
    rng = np.random.default_rng(0)
    ts = np.arange(0.0, traj.timestamps[-1], 0.1)
    gt_t, est_t, gt_j, est_j = [], [], [], []
    for i, t in enumerate(ts):
        p = traj.interpolate_pose(t)
        tr = p.tr + 0.002 * i * np.array([1.0, 0.5, 0.0]) \
            + rng.normal(scale=0.01, size=3)
        q = p.quat + rng.normal(scale=1e-3, size=4)
        q /= np.linalg.norm(q)
        gt_t.append(TPose(p.quat, p.tr))
        est_t.append(TPose(q, tr))
        gt_j.append(JPose(p.quat, p.tr))
        est_j.append(JPose(q, tr))
    for driving in (True, False):
        a = tkitti.evaluate_poses(gt_t, est_t, driving=driving)
        b = jkitti.evaluate_poses(gt_j, est_j, driving=driving)
        assert a.to_dict() == b.to_dict()
        assert a.tab_errors == b.tab_errors
        assert a.mean_rpe > 0 and len(a.tab_errors) > 10


@pytest.mark.parametrize("depth", [1, 32])
def test_prefetch_keeps_order_and_raises(depth):
    def slow_square(i):
        time.sleep(0.002 * ((7 * i) % 5))     # finish out of order
        return i * i

    assert list(PrefetchIterator(range(40), slow_square, depth=depth)) == [
        i * i for i in range(40)]

    def fails_at_5(i):
        if i == 5:
            raise KeyError("frame 5")
        return i

    seen = []
    with pytest.raises(KeyError, match="frame 5"):
        with PrefetchIterator(range(20), fails_at_5, depth=depth) as it:
            for item in it:
                seen.append(item)
    assert seen == [0, 1, 2, 3, 4]
    # the source is walked in a background thread; an identity transform
    # gives its items in order, and the source's own exception is raised
    main = threading.get_ident()
    threads = []

    def source(fail=False):
        for i in range(5):
            threads.append(threading.get_ident())
            yield i
        if fail:
            raise ValueError("source ended badly")

    assert list(PrefetchIterator(source(), lambda x: x, depth=depth)) == [
        0, 1, 2, 3, 4]
    assert main not in threads
    with pytest.raises(ValueError, match="ended badly"):
        list(PrefetchIterator(source(fail=True), lambda x: x, depth=depth))


def test_gate_constants_match_bench():
    assert (ld.LONG_TR_BOUND_PCT, ld.LONG_SEEDS, ld.LONG_CONFIG) == \
        (bench.LONG_TR_BOUND_PCT, bench.LONG_SEEDS, bench.LONG_CONFIG)
    from ct_icp_torch.datasets import corridor
    from ct_icp_torch.tools import bench as tbench
    assert (corridor.APE_BOUND_M, corridor.APE_SEEDS,
            corridor.ROBUST_APE_BOUND_M) == (bench.APE_BOUND_M,
                                             bench.APE_SEEDS,
                                             bench.ROBUST_APE_BOUND_M)
    # the reference's gates, and the port's own beside them: the replay
    # gate of the reference's tests/test_ct_ba.py and the backend on a
    # robust profile
    reference_gates = {"--driving", "--robust", "--escalation", "--long",
                       "--indoor", "--backend"}
    assert reference_gates <= set(bench.GATES)
    assert set(tbench.GATES) == reference_gates | {"--replay",
                                                   "--backend-robust"}
    assert (tbench.BACKEND_TR_BOUND_PCT, tbench.BACKEND_FRAMES,
            tbench.BACKEND_SEED) == (bench.BACKEND_TR_BOUND_PCT,
                                     bench.BACKEND_FRAMES,
                                     bench.BACKEND_SEED)
    # without a card the tool refuses, and prints no result
    if not tbench.torch.cuda.is_available():
        assert tbench.main(["--long"]) == 2
    assert tbench.main(["--nope"]) == 2
