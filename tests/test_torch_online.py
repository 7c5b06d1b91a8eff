"""The port's online node, its node analogs, the visualization export,
the timer and the IMU type against ct_icp_tpu's (CPU):

* ``OnlineOdometry`` on tests/test_odometry.py's small options and room:
  4 frames, then a frame 0.5 s late that the timestamp gate drops; the
  published poses within the cross-package bound (5 mm, 0.05 deg), the
  published world points (device tensors in the port) with the reference's
  valid rows and within the bound times their range, the gate's events
  equal;
* the failure dump of a node whose assessment fails frame 1: the initial
  frame, the frame and the map files byte for byte;
* ``DatasetPublisher``'s messages and ``EvaluationNode``'s metrics equal
  (numpy float64 in both);
* ``AggregatedFramesDump`` (registered on the node's odometry) and
  ``export_map_ply``;
* ``Timer`` on one clock, ``ImuData`` pack / unpack byte for byte."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from ct_icp_torch.core import imu as timu
from ct_icp_torch.core import timer as ttimer
from ct_icp_torch.io import ply as tply
from ct_icp_torch.online import DatasetPublisher as TPublisher
from ct_icp_torch.online import EvaluationNode as TEval
from ct_icp_torch.online import OnlineOdometry as TNode
from ct_icp_torch.online import OnlineOdometryConfig as TConfig
from ct_icp_torch.visualization import AggregatedFramesDump as TDump
from ct_icp_torch.visualization import export_map_ply as texport
from ct_icp_tpu.core import imu as jimu
from ct_icp_tpu.core import timer as jtimer
from ct_icp_tpu.online import DatasetPublisher as JPublisher
from ct_icp_tpu.online import EvaluationNode as JEval
from ct_icp_tpu.online import OnlineOdometry as JNode
from ct_icp_tpu.online import OnlineOdometryConfig as JConfig
from ct_icp_tpu.visualization import AggregatedFramesDump as JDump
from ct_icp_tpu.visualization import export_map_ply as jexport
from tests.test_odometry import small_options
from tests.torch_surface_cases import (ACROSS, assert_points_close,
                                       frames, host_points, port_options)

GATED = 8                     # frame 8 after frame 3: 0.5 s, not 0.1


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One torch thread: the plain kernels run many small ops, and the other
    test workers keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _gt():
    """The ground truth in the estimate's frame: frame 0 ends at the
    identity (the node does not move frame 0)."""
    first = frames()[0]["end_pose"]
    return [(first.inverse() * f["end_pose"]).matrix() for f in frames()]


def _run(node, dump, evaluation):
    rec = {"poses": [], "points": [], "monitor": [], "summaries": []}
    node.pose_output.subscribe(rec["poses"].append)
    node.pose_output.subscribe(evaluation.on_pose)
    node.points_output.subscribe(rec["points"].append)
    node.monitor_output.subscribe(rec["monitor"].append)
    node.odometry.register_callback(node.odometry.FINISHED_REGISTRATION,
                                    dump)
    for i in list(range(4)) + [GATED]:
        fr = frames()[i]
        rec["summaries"].append(node.on_pointcloud(fr["xyz"],
                                                   fr["timestamps"]))
    dump.flush(node.odometry)
    rec["metrics"] = evaluation.compute_metrics()
    return rec


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    out = tmp_path_factory.mktemp("online")
    t = _run(TNode(TConfig(odometry_options=port_options(),
                           expected_frame_period=0.1), device="cpu"),
             TDump(out / "port_viz", period=2), TEval(_gt(), 100.0))
    j = _run(JNode(JConfig(odometry_options=small_options(),
                           expected_frame_period=0.1)),
             JDump(out / "ref_viz", period=2), JEval(_gt(), 100.0))
    return t, j, out


def test_node_poses_and_gate(nodes):
    t, j, _ = nodes
    assert [s is None for s in t["summaries"]] == [False] * 4 + [True]
    assert [s is None for s in j["summaries"]] == [False] * 4 + [True]
    assert all(s.success for s in t["summaries"][:4])
    assert [m["frame_id"] for m in t["poses"]] == [0, 1, 2, 3]
    for a, b in zip(t["poses"], j["poses"]):
        assert a["frame_id"] == b["frame_id"]
        for key in ("begin_pose", "end_pose"):
            assert a[key].location_distance(b[key]) < ACROSS[0]
            assert a[key].angular_distance(b[key]) < ACROSS[1]
    drop_t = [m for m in t["monitor"] if m.get("event") == "frame_dropped"]
    drop_j = [m for m in j["monitor"] if m.get("event") == "frame_dropped"]
    assert drop_t == drop_j and len(drop_t) == 1
    assert abs(drop_t[0]["r_dt"] - (GATED - 3)) < 0.1
    logged = [m for m in t["monitor"] if "event" not in m]
    assert len(logged) == 4 and all("odometry_total" in m for m in logged)


def test_node_world_points(nodes):
    """The published world points: the device tuple, the reference's valid
    rows, within the bound times the range."""
    t, j, _ = nodes
    assert len(t["points"]) == len(j["points"]) == 4
    for tp, jp, s in zip(t["points"], j["points"], j["summaries"]):
        assert torch.is_tensor(tp[0]) and torch.is_tensor(tp[1])
        assert int(tp[1].sum()) == int(np.asarray(jp[1]).sum())
        assert_points_close(host_points(tp), host_points(jp),
                            s.frame.end_pose.tr)


def test_evaluation_node_metrics(nodes):
    t, j, _ = nodes
    mt, mj = t["metrics"], j["metrics"]
    assert abs(mt.mean_ape - mj.mean_ape) < ACROSS[0] and mj.mean_ape < 0.1
    # the same poses give the same metrics, bit for bit
    te, je = TEval(_gt(), 100.0), JEval(_gt(), 100.0)
    got_t, got_j = [], []
    te.metrics_output.subscribe(got_t.append)
    je.metrics_output.subscribe(got_j.append)
    for m in j["poses"]:
        te.on_pose(m)
        je.on_pose(m)
    assert dataclasses.asdict(te.compute_metrics()) == \
        dataclasses.asdict(je.compute_metrics())
    assert len(got_t) == len(got_j) == 1
    assert TEval(_gt(), 1.0).compute_metrics() is None
    # the background thread computes and publishes on its period
    node = TEval(_gt(), 0.01)
    for m in j["poses"]:
        node.on_pose(m)
    seen = []
    node.metrics_output.subscribe(seen.append)
    node.start()
    deadline = time.time() + 5.0
    while not seen and time.time() < deadline:
        time.sleep(0.01)
    node.stop()
    assert seen and dataclasses.asdict(seen[0]) == \
        dataclasses.asdict(je.compute_metrics())


def test_aggregated_dump_and_map_export(nodes):
    t, j, out = nodes
    names = sorted(p.name for p in (out / "port_viz").iterdir())
    assert names == sorted(p.name for p in (out / "ref_viz").iterdir()) == [
        "aggregated_000002.ply", "aggregated_000004.ply", "trajectory.ply"]
    centre = j["summaries"][3].frame.end_pose.tr
    for name in names:
        a = tply.read_ply(out / "port_viz" / name)
        b = tply.read_ply(out / "ref_viz" / name)
        pa = np.stack([a["x"], a["y"], a["z"]], 1).astype(np.float64)
        pb = np.stack([b["x"], b["y"], b["z"]], 1).astype(np.float64)
        assert_points_close(pa, pb, centre)
    # the aggregated points are the frames' valid corrected points
    counts = [int(p[1].sum()) for p in t["points"]]
    agg = [len(tply.read_ply(out / "port_viz" / n)["x"]) for n in names[:2]]
    assert agg == [counts[0] + counts[1], counts[2] + counts[3]]


def test_map_export_equal_after_frame_zero(tmp_path):
    """export_map_ply of frame 0's map (identity pose: the same points in
    both packages bit for bit; K10's normals against the reference's refit
    within 1e-4)."""
    from ct_icp_tpu.odometry.odometry import Odometry as JOdometry
    from ct_icp_torch.odometry.odometry import Odometry as TOdometry
    fr = frames()[0]
    todo = TOdometry(port_options(), device="cpu")
    jodo = JOdometry(small_options())
    for odo in (todo, jodo):
        odo.register_frame(fr["xyz"], fr["timestamps"], frame_id=0)
    for level in (0, 2):
        texport(todo, tmp_path / f"t{level}.ply", level)
        jexport(jodo, tmp_path / f"j{level}.ply", level)
        a = tply.read_ply(tmp_path / f"t{level}.ply")
        b = tply.read_ply(tmp_path / f"j{level}.ply")
        assert list(a) == list(b) == ["x", "y", "z", "nx", "ny", "nz"]
        for k in ("x", "y", "z"):
            np.testing.assert_array_equal(a[k], b[k])
        # float32 eigensolves of nearly degenerate covariances: 1.8e-5
        for k in ("nx", "ny", "nz"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-4)


def test_failure_dump(tmp_path):
    """A node whose assessment fails at frame 1 (a 1 um distance
    threshold) dumps the initial frame, the frame and the map, and stops."""
    def config(cls, opts):
        return cls(odometry_options=opts, expected_frame_period=0.1,
                   failure_output_dir=str(tmp_path / cls.__module__))
    t = TNode(config(TConfig, port_options(distance_error_threshold=1e-6)),
              device="cpu")
    j = JNode(config(JConfig, small_options(distance_error_threshold=1e-6)))
    for node in (t, j):
        events = []
        node.monitor_output.subscribe(events.append)
        out = [node.on_pointcloud(f["xyz"], f["timestamps"])
               for f in frames()[:3]]
        assert out[0].success and not out[1].success and out[2] is None
        assert node.stopped
        assert [e["event"] for e in events if "event" in e] == ["failure"]
    dt, dj = (tmp_path / "ct_icp_torch.online"), (tmp_path /
                                                   "ct_icp_tpu.online")
    names = sorted(p.name for p in dt.iterdir())
    assert names == sorted(p.name for p in dj.iterdir()) == [
        "frame.ply", "initial_frame.ply", "map.ply"]
    for name in names:
        assert (dt / name).read_bytes() == (dj / name).read_bytes(), name


class _Sequence:
    def __init__(self, n):
        self._frames = [{"xyz": np.full((5, 3), float(i)),
                         "timestamps": np.arange(5.0)} for i in range(n)]
        self._i = 0

    def has_next(self):
        return self._i < len(self._frames)

    def next_frame(self):
        fr = self._frames[self._i]
        self._i += 1
        return fr


def test_dataset_publisher():
    got = {}
    for cls in (TPublisher, JPublisher):
        pub = cls(_Sequence(5), rate_hz=0.0)
        msgs = got.setdefault(cls, [])
        pub.output.subscribe(msgs.append)

        def stop_at_4(m, pub=pub):
            if m["frame_id"] == 3:
                pub.stop()
        pub.output.subscribe(stop_at_4)
        pub.run()
        assert not pub.step()
    a, b = got[TPublisher], got[JPublisher]
    assert [m["frame_id"] for m in a] == [m["frame_id"] for m in b] == \
        [0, 1, 2, 3]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["xyz"], y["xyz"])
        np.testing.assert_array_equal(x["timestamps"], y["timestamps"])
    # a paced run sleeps out its period
    pub = TPublisher(_Sequence(3), rate_hz=50.0)
    t0 = time.monotonic()
    pub.run()
    assert time.monotonic() - t0 >= 0.05


def test_timer_and_imu(monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.125))
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timers = (ttimer.Timer(), jtimer.Timer())
    for t in timers:
        for name in ("b", "a", "b"):
            with t.tick(name):
                pass
    assert timers[0].report() == timers[1].report()
    assert timers[0].entries() == timers[1].entries() == ["b", "a"]
    assert timers[0].average_ms("b") == timers[1].average_ms("b") == 125.0
    assert timers[0].cumulated_ms("z") == timers[0].average_ms("z") == 0.0
    timers[0].clear()
    assert timers[0].entries() == []

    assert timu.IMU_DTYPE == jimu.IMU_DTYPE
    assert timu.IMU_DTYPE.descr == jimu.IMU_DTYPE.descr
    items_t = [timu.ImuData(1.0, np.ones(3), np.arange(3.0)),
               timu.ImuData(2.5, np.zeros(3), np.ones(3),
                            np.array([1.0, 0, 0, 0])), timu.ImuData()]
    items_j = [jimu.ImuData(1.0, np.ones(3), np.arange(3.0)),
               jimu.ImuData(2.5, np.zeros(3), np.ones(3),
                            np.array([1.0, 0, 0, 0])), jimu.ImuData()]
    pt, pj = timu.ImuData.pack(items_t), jimu.ImuData.pack(items_j)
    assert pt.tobytes() == pj.tobytes()
    for a, b in zip(timu.ImuData.unpack(pt), jimu.ImuData.unpack(pj)):
        assert a.timestamp == b.timestamp
        for f in ("angular_velocity", "linear_acceleration", "orientation"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
