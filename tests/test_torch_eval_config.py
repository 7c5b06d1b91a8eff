"""The port's evaluation, geometry and option readers against ct_icp_tpu's:
the KITTI metrics and the segment ATE on the same trajectories (within
1e-12 relative), the metrics.yaml text character for character, the
Procrustes alignment and the geometric median (1e-12), every
``configs/*.yaml`` through both packages' readers (equal option values,
``dataclasses.asdict`` field by field), and the regression harness's
baseline writer read back by the port's own YAML reader."""

import dataclasses
import enum
import glob

import numpy as np
import pytest
import yaml

from ct_icp_torch.config import yaml_config as TY
from ct_icp_torch.core import geometry as tgeo
from ct_icp_torch.core.pose import Pose as TPose
from ct_icp_torch.core.trajectory import LinearContinuousTrajectory as TLCT
from ct_icp_torch.evaluation import kitti as tev
from ct_icp_torch.evaluation import trajectory_metrics as ttm
from ct_icp_torch import regression as treg
from ct_icp_tpu.config import yaml_config as JY
from ct_icp_tpu.core import geometry as jgeo
from ct_icp_tpu.core.pose import Pose as JPose
from ct_icp_tpu.core.trajectory import LinearContinuousTrajectory as JLCT
from ct_icp_tpu.evaluation import kitti as jev
from ct_icp_tpu.evaluation import trajectory_metrics as jtm
from ct_icp_tpu import regression as jreg

REL = 1e-12
CONFIGS = sorted(glob.glob("configs/*.yaml"))


def _trajectories(seed, n, step, pose_cls):
    """A wandering ground truth and a drifting, noisy estimate of it."""
    rng = np.random.default_rng(seed)
    gt, est = [], []
    yaw = np.cumsum(rng.normal(scale=0.02, size=n))
    pos = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw),
                              0.01 * rng.normal(size=n)], 1) * step, 0)
    for i in range(n):
        q = np.array([np.cos(yaw[i] / 2), 0, 0, np.sin(yaw[i] / 2)])
        gt.append(pose_cls(q, pos[i], float(i) * 0.1, i))
        dq = rng.normal(scale=1e-3, size=4)
        dq[0] = 1.0
        qe = q + dq
        est.append(pose_cls(qe / np.linalg.norm(qe),
                            pos[i] * 1.004 + rng.normal(scale=0.02, size=3),
                            float(i) * 0.1, i))
    return gt, est


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=REL, atol=0)


@pytest.mark.parametrize("driving,n,step", [(True, 1200, 1.0),
                                            (False, 400, 0.3)])
def test_kitti_metrics(driving, n, step):
    tg, te = _trajectories(1, n, step, TPose)
    jg, je = _trajectories(1, n, step, JPose)
    t = tev.evaluate_poses(tg, te, driving=driving)
    j = jev.evaluate_poses(jg, je, driving=driving)
    assert t.to_dict().keys() == j.to_dict().keys()
    for k, v in t.to_dict().items():
        _close(v, j.to_dict()[k])
    assert len(t.tab_errors) == len(j.tab_errors) > 0


def test_continuous_trajectory_and_metrics_yaml():
    tg, te = _trajectories(2, 300, 0.5, TPose)
    jg, je = _trajectories(2, 300, 0.5, JPose)
    t = tev.evaluate_continuous_trajectory(tg, TLCT(te[::3]), driving=False)
    j = jev.evaluate_continuous_trajectory(jg, JLCT(je[::3]), driving=False)
    for k, v in t.to_dict().items():
        _close(v, j.to_dict()[k])
    t.average_elapsed_ms = j.average_elapsed_ms = 12.5
    # the same numbers give the same text (a float printed the same way)
    jt = jev.SeqErrors(**{f.name: getattr(t, f.name)
                          for f in dataclasses.fields(jev.SeqErrors)})
    text = tev.generate_metrics_yaml({"00": t, "seq b": t})
    assert text == jev.generate_metrics_yaml({"00": jt, "seq b": jt})
    assert TY.load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("seg", [5.0, 10.0])
def test_segment_ate(seg):
    tg, te = _trajectories(3, 200, 0.4, TPose)
    jg, je = _trajectories(3, 200, 0.4, JPose)
    t = ttm.compute_trajectory_metrics(tg, te, segment_length=seg)
    j = jtm.compute_trajectory_metrics(jg, je, segment_length=seg)
    for k in ("mean_ate", "max_ate", "segment_mean_ate",
              "segment_mean_ate_ratio", "total_distance"):
        _close(getattr(t, k), getattr(j, k))
    assert t.max_ate_idx == j.max_ate_idx
    assert len(t.trajectory_segments) == len(j.trajectory_segments) > 0
    _close(t.loc_errors, j.loc_errors)
    _close(t.distances, j.distances)
    _close(np.concatenate(t.rigid_transform), np.concatenate(j.rigid_transform))
    assert ttm.generate_trajectory_metrics_yaml(t) == \
        jtm.generate_trajectory_metrics_yaml(j)


def test_procrustes_and_geometric_median():
    rng = np.random.default_rng(4)
    ref = rng.normal(size=(60, 3))
    tgt = ref @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 1.5 + \
        rng.normal(scale=0.01, size=(60, 3))
    for a, b in zip(tgeo.orthogonal_procrustes(ref, tgt),
                    jgeo.orthogonal_procrustes(ref, tgt)):
        _close(a, b)
    planar = ref.copy()
    planar[:, 2] = 0.0
    for a, b in zip(tgeo.orthogonal_procrustes(planar, tgt),
                    jgeo.orthogonal_procrustes(planar, tgt)):
        _close(a, b)
    pts = np.concatenate([rng.normal(scale=0.05, size=(30, 3)),
                          [[40.0, 0.0, 0.0]]])
    for a, b in zip(tgeo.geometric_median(pts), jgeo.geometric_median(pts)):
        _close(a, b)


def _plain(x):
    """asdict of an options tree, enums as their values (the two packages'
    enum classes differ)."""
    if dataclasses.is_dataclass(x):
        return {k: _plain(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, enum.Enum):
        return x.value
    return x


@pytest.mark.parametrize("path", CONFIGS)
def test_config_files_parse_the_same(path):
    text = open(path).read()
    root = yaml.safe_load(text)
    assert TY.load_yaml(text) == root
    if "scene" in root:            # a synthetic scene, not options
        t = TY.synthetic_sequence_from_yaml(path)
        j = JY.synthetic_sequence_from_yaml(path).acq
        assert t.num_frames() == j.num_frames()
        return
    if "runs" in root:             # a regression baseline
        t, j = (m.load_regression_config(path) for m in (treg, jreg))
        assert _plain(t) == _plain(j)
        assert t.runs and t.odometry_options is not None
        return
    t, j = TY.load_runner_config(path), JY.load_runner_config(path)
    assert _plain(t) == _plain(j)
    assert _plain(TY.read_odometry_options(path)) == \
        _plain(JY.yaml_to_odometry_options(root))


def test_option_readers_on_every_section():
    """Each reader on a node with every section the readers know,
    unknown keys among them."""
    node = {
        "voxel_size": 0.4, "sampling": "ADAPTIVE", "robust_registration": 1,
        "unknown": 3,
        "map_options": {"default_radius": 1.1, "resolutions": [
            {"resolution": 0.5, "max_num_points": 20},
            {"resolution": 1.5, "capacity_log2": 17}]},
        "neighborhood_strategy": {"type": "DISTANCE_BASED_STRATEGY",
                                  "max_num_neighbors": 12},
        "default_motion_model": {"beta_small_velocity": 0.3},
        "ct_icp_options": {"num_iters_icp": 7, "loss_function": "HUBER",
                           "solver": "GN"},
        "adaptive_options": {"num_points_per_voxel": 2},
        "backend": {"enabled": True, "window": 6, "replay": "yes"},
    }
    assert _plain(TY.yaml_to_odometry_options(node)) == \
        _plain(JY.yaml_to_odometry_options(node))
    ds = {"dataset": "NCLT", "root_path": "/x", "nclt_num_aggregated_pc": 4,
          "sequence_options": [{"sequence_name": "a", "max_num_frames": 3}]}
    assert _plain(TY.yaml_to_dataset_options_vector([ds, ds])) == \
        _plain(JY.yaml_to_dataset_options_vector([ds, ds]))
    runner = {"output_dir": "o", "max_frames": 9, "html_viewer": True,
              "odometry_options": node, "dataset_options": [ds]}
    assert _plain(TY.runner_config_from_node(runner)) == \
        _plain(JY.runner_config_from_node(runner))


def test_regression_baseline_writer_reads_back():
    runs = [treg.RegressionRun("00", 0.25, 0.0123, 0.061, 40, 0),
            treg.RegressionRun("Synthetic Scene", float("inf"), 1e-9,
                               3.0, -1, 12)]
    out = {"tolerance_tr": 1e-5, "tolerance_time_sec": 0.7,
           "tolerance_ape_m": 0.01,
           "runs": [dataclasses.asdict(r) for r in runs]}
    text = treg.dump_yaml(out)
    assert TY.load_yaml(text) == out
    assert yaml.safe_load(text) == out
    assert yaml.safe_load(yaml.safe_dump(out)) == TY.load_yaml(text)
