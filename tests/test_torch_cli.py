"""The port's entry points around the runner, on the CPU: ``python -m
ct_icp_torch.cli`` (``cli.main`` with ``--device cpu``) on a KITTI-layout
directory of PLY frames with ground truth, the regression harness
(``ct_icp_torch/regression.py``) with its three outcomes and its decisions
and baseline file held to ct_icp_tpu's on the same sequence results, and
the HTML viewer (the same file as ct_icp_tpu's for the same points, the
map of an odometry, the runner's ``html_viewer`` flag)."""

import base64
import re

import numpy as np
import pytest
import torch
import yaml

from ct_icp_torch import cli
from ct_icp_torch import regression as treg
from ct_icp_torch import viewer as tview
from ct_icp_torch.config.yaml_config import read_yaml
from ct_icp_torch.datasets import dataset as TD
from ct_icp_torch.evaluation import kitti as tev
from ct_icp_torch.odometry.odometry import Odometry
from ct_icp_torch.runner import SequenceResult as TResult
from ct_icp_torch.tools import runner_data
from ct_icp_tpu import regression as jreg
from ct_icp_tpu import viewer as jview
from ct_icp_tpu.datasets import dataset as JD
from ct_icp_tpu.evaluation import kitti as jev
from ct_icp_tpu.runner import SequenceResult as JResult
from tests.torch_runner_cases import options_pair, port_acquisition


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One torch thread: the plain kernels run many small ops, and the other
    test workers keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# tests/test_odometry.py's small_options as a runner config
SMALL_YAML = """
compute_metrics_period: 0
progress_bar: false
odometry_options:
  init_num_frames: 5
  max_distance: 100.0
  max_scan_points: 8192
  max_subsampled_points: 8192
  max_keypoints: 2048
  max_dirty_voxels: 4096
  map_options:
    default_radius: 0.8
    resolutions:
      - resolution: 0.2
        min_distance_between_points: 0.03
        max_num_points: 30
        capacity_log2: 16
      - resolution: 0.5
        min_distance_between_points: 0.1
        max_num_points: 25
        capacity_log2: 15
      - resolution: 1.5
        min_distance_between_points: 0.15
        max_num_points: 25
        capacity_log2: 13
  ct_icp_options:
    num_iters_icp: 6
    ls_max_num_iters: 2
    min_number_neighbors: 10
    min_num_residuals: 50
"""


# tests/test_odometry.py's room as a scene file, 8 frames of 6,000 points
ROOM_YAML = """
seed: 5
scene:
  - type: box_room
    half_extent: 12.0
    height: 5.0
  - type: sphere
    center: [0.0, 0.0, 2.0]
    radius: 2.0
  - type: ball
    center: [5.0, -4.0, 1.0]
    radius: 1.0
  - type: rectangle
    corner: [-4, 2, 0]
    edge_u: [3, 0, 0]
    edge_v: [0, 0, 3]
trajectory:
  type: circle
  radius: 6.0
  height: 1.5
  num_poses: 200
  total_time: 1.0
  angle_span: 1.2
acquisition:
  num_points_per_frame: 6000
  max_range: 60.0
"""


def _embedded(html, name):
    m = re.search(name + r' = decode\("([A-Za-z0-9+/=]*)"\)', html)
    return np.frombuffer(base64.b64decode(m.group(1)), np.float32)


def test_small_yaml_is_small_options():
    from ct_icp_torch.config.yaml_config import (load_yaml,
                                                 runner_config_from_node)
    cfg = runner_config_from_node(load_yaml(SMALL_YAML))
    assert cfg.odometry_options == options_pair()[1]


def test_cli_on_kitti_layout(tmp_path):
    acq = port_acquisition(seed=11)
    frames = [acq.frame(i) for i in range(6)]
    runner_data.write_kitti_sequence(frames, tmp_path / "data")
    cfg = tmp_path / "run.yaml"
    cfg.write_text(SMALL_YAML)
    out = tmp_path / "out"
    code = cli.main(["-c", str(cfg), "--dataset", "KITTI", "--root-path",
                     str(tmp_path / "data"), "--output-dir", str(out),
                     "--html-viewer", "--device", "cpu",
                     "--trace-dir", str(tmp_path / "trace")])
    assert code == 0
    (run_dir,) = out.iterdir()            # the time-stamped directory
    metrics = read_yaml(run_dir / "metrics.yaml")
    assert metrics["00"]["success"] is True
    assert metrics["00"]["MEAN_APE"] < 0.3
    seq = TD.Dataset.load_dataset(TD.DatasetOptions(
        dataset=TD.DatasetEnum.KITTI, root_path=str(tmp_path / "data"))
    ).sequence("00")
    gt = seq.ground_truth()
    for a, b in zip(gt, runner_data.mid_frame_ground_truth(frames)):
        # the written ground truth reads back (the format's digits)
        assert a.location_distance(b) < 1e-6
    html = (run_dir / "00" / "viewer.html").read_text()
    assert _embedded(html, "traj").size == 3 * 6
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    for f in ("00.txt", "00_ct_trajectory.txt", "trajectory.ply"):
        assert (run_dir / "00" / f).stat().st_size > 0


def test_cli_needs_a_dataset(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu"])
    assert "No datasets configured" in capsys.readouterr().err


def _fake_results(mod_result, mod_ev, tr, ape, ms):
    return mod_result(name="Synthetic Scene", num_frames=8, finished=True,
                      avg_runtime_ms=ms, metrics=mod_ev.SeqErrors(
                          mean_rpe=tr, mean_ape=ape))


@pytest.mark.parametrize("case", [
    dict(tr=0.5, ape=0.05, ms=100.0),
    dict(tr=2.5, ape=0.05, ms=100.0),       # precision (Tr) regression
    dict(tr=0.5, ape=0.30, ms=100.0),       # precision (APE) regression
    dict(tr=0.5, ape=0.05, ms=900.0),       # runtime regression
])
def test_regression_decisions_match_reference(tmp_path, monkeypatch, case):
    """Both packages' harnesses on the same sequence results: the same
    verdict and the same baseline values written."""
    verdicts, written = [], []
    for mod, result, ev in ((treg, TResult, tev), (jreg, JResult, jev)):
        monkeypatch.setattr(
            mod.OdometryRunner, "run_sequence",
            lambda self, seq, driving=True, **kw: _fake_results(
                result, ev, **case))
        ds = (TD if mod is treg else JD)
        cfg = mod.RegressionConfig(
            tolerance_tr=0.1, tolerance_time_sec=0.2, tolerance_ape_m=0.05,
            runs=[mod.RegressionRun("Synthetic Scene", kitti_Tr=1.0,
                                    avg_runtime_sec=0.5, mean_ape_m=0.1,
                                    max_num_frames=8)],
            dataset_options=ds.DatasetOptions(
                dataset=ds.DatasetEnum.SYNTHETIC,
                root_path="configs/synthetic_courtyard.yaml"),
            odometry_options=options_pair()[0 if mod is jreg else 1])
        out = tmp_path / f"{mod.__name__}.yaml"
        verdicts.append(mod.run_regression(cfg, str(out)))
        written.append(yaml.safe_load(out.read_text()))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0] == (case == dict(tr=0.5, ape=0.05, ms=100.0))
    assert written[0] == written[1]
    assert read_yaml(tmp_path / "ct_icp_torch.regression.yaml") == written[0]


def test_regression_three_outcomes(tmp_path):
    """The port's harness on 6 real frames of a room: passes within
    tolerance and writes the measured baseline; fails an impossible runtime
    baseline; fails an APE baseline at half the measured APE."""
    _, to = options_pair()
    (tmp_path / "room.yaml").write_text(ROOM_YAML)
    cfg = treg.RegressionConfig(
        tolerance_tr=0.05, tolerance_time_sec=-1.0,
        runs=[treg.RegressionRun(sequence_name="Synthetic Scene",
                                 kitti_Tr=2.0, max_num_frames=6)],
        dataset_options=TD.DatasetOptions(
            dataset=TD.DatasetEnum.SYNTHETIC,
            root_path=str(tmp_path / "room.yaml")),
        odometry_options=to)
    out = tmp_path / "updated.yaml"
    assert treg.run_regression(cfg, str(out), device="cpu")
    updated = read_yaml(out)
    assert updated == yaml.safe_load(out.read_text())
    assert updated["runs"][0]["kitti_Tr"] < 2.0
    ape = updated["runs"][0]["mean_ape_m"]
    assert 0.0 < ape < 0.3
    cfg.runs[0].avg_runtime_sec, cfg.tolerance_time_sec = 1e-9, 0.0
    assert not treg.run_regression(cfg, device="cpu")
    cfg.runs[0].avg_runtime_sec = -1.0
    cfg.runs[0].mean_ape_m, cfg.tolerance_ape_m = ape / 2.0, ape / 10.0
    assert not treg.run_regression(cfg, device="cpu")


def test_export_html_same_as_reference(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (5000, 3))
    traj = np.stack([np.linspace(0, 9, 10), np.zeros(10), np.ones(10)], -1)
    for kw in (dict(), dict(max_points=1000)):
        t = tview.export_html(tmp_path / "t.html", pts, traj, title="x",
                              **kw).read_text()
        j = jview.export_html(tmp_path / "j.html", pts, traj, title="x",
                              **kw).read_text()
        assert t == j.replace("ct_icp_tpu", "ct_icp_torch")
    t = tview.export_html(tmp_path / "t.html", pts[:10]).read_text()
    assert _embedded(t, "traj").size == 0
    with pytest.raises(ValueError):
        tview.export_html(tmp_path / "bad.html", np.zeros((5, 2)))


def test_export_odometry_html(tmp_path):
    _, to = options_pair()
    acq = port_acquisition(seed=2)
    odo = Odometry(to, device="cpu")
    for i in range(3):
        fr = acq.frame(i)
        odo.register_frame(fr["xyz"], fr["timestamps"], frame_id=i)
    html = tview.export_odometry_html(odo, tmp_path / "map.html").read_text()
    pts = _embedded(html, "pts").reshape(-1, 3)
    np.testing.assert_array_equal(
        pts, odo.get_map_points(0)[:, :3].astype(np.float32))
    assert len(pts) > 1000
    assert len(_embedded(html, "traj")) == 3 * 3
