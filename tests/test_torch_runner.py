"""The port's runner (``ct_icp_torch/runner.py``) against ct_icp_tpu's on
the CPU: ``run_sequence`` over a 10-frame synthetic sequence and over a
6-frame PLY directory written by ``convert_sequence``, the poses within
tests/test_torch_odometry.py's bounds (5 mm, 0.05 deg) of the reference
runner's, the output files present and parsed (the KITTI poses, the CT
trajectory, trajectory.ply and metrics.yaml: the files the port's writers
give for the port's own trajectory, byte for byte); and a degenerate
frame, which fails the sequence at the same frame as the reference but
keeps the registered prefix and its outputs."""

import numpy as np
import pytest
import torch

from ct_icp_torch.config.yaml_config import RunnerConfig as TConfig
from ct_icp_torch.config.yaml_config import load_yaml
from ct_icp_torch.convert import convert_sequence
from ct_icp_torch.datasets import dataset as TD
from ct_icp_torch.io import ply as tply
from ct_icp_torch.io import trajectory_io as ttio
from ct_icp_torch.runner import OdometryRunner as TRunner
from ct_icp_torch.runner import mid_frame_poses
from ct_icp_tpu.config.yaml_config import RunnerConfig as JConfig
from ct_icp_tpu.datasets import dataset as JD
from ct_icp_tpu.runner import OdometryRunner as JRunner
from tests.torch_runner_cases import acquisitions, end_gap, options_pair

ACROSS = (5e-3, 0.05)         # tests/test_torch_odometry.py:109-110
N = {"synthetic": 10, "ply_directory": 6}     # frames a run


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One torch thread: the plain kernels run many small ops, and the other
    test workers keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _runners(out):
    """(the port's runner writing under out/port, the reference's under
    out/ref)."""
    jo, to = options_pair()
    kw = dict(generate_directory_prefix=False, progress_bar=False,
              compute_metrics_period=0)
    return (TRunner(TConfig(odometry_options=to, output_dir=str(out / "port"),
                            **kw), device="cpu"),
            JRunner(JConfig(odometry_options=jo, output_dir=str(out / "ref"),
                            **kw)))


def _check_outputs(seq_dir, name, runner, result, tmp_path):
    traj = runner._last_odometry.get_trajectory()
    mids = mid_frame_poses(traj)
    ttio.save_poses_kitti_format(tmp_path / "mids.txt", mids)
    ttio.save_trajectory_frames(tmp_path / "ct.txt", traj)
    assert (seq_dir / f"{name}.txt").read_text() == \
        (tmp_path / "mids.txt").read_text()
    assert (seq_dir / f"{name}_ct_trajectory.txt").read_text() == \
        (tmp_path / "ct.txt").read_text()
    assert len(ttio.load_poses_kitti_format(seq_dir / f"{name}.txt")) == \
        len(ttio.load_trajectory_frames(
            seq_dir / f"{name}_ct_trajectory.txt")) == result.num_frames
    cols = tply.read_ply(seq_dir / "trajectory.ply")
    np.testing.assert_array_equal(
        np.stack([cols["x"], cols["y"], cols["z"]], 1),
        np.stack([p.tr for p in mids]).astype(np.float32))


def _keep_odometry(runner):
    """Remember the Odometry run_sequence makes (the test reads its
    trajectory after the run)."""
    inner = runner.run_sequence

    def run(seq, driving=True, odometry=None):
        from ct_icp_torch.odometry.odometry import Odometry
        odo = odometry or Odometry(runner.config.odometry_options,
                                   device=runner.device)
        runner._last_odometry = odo
        return inner(seq, driving=driving, odometry=odo)
    runner.run_sequence = run


@pytest.mark.parametrize("source", ["synthetic", "ply_directory"])
def test_run_sequence_matches_reference(tmp_path, source):
    acqs = acquisitions(17 if source == "synthetic" else 23)
    seqs = []
    if source == "synthetic":
        for mod, acq in zip((TD, JD), acqs):
            s = mod.SyntheticSequence(acq)
            s.set_max_num_frames(N[source])
            seqs.append(s)
    else:
        src = TD.SyntheticSequence(acqs[0])
        frames_dir = tmp_path / "seq" / "frames"
        assert convert_sequence(src, frames_dir, max_frames=N[source]) == 6
        from ct_icp_tpu.core.pose import Pose as JPose
        gt = src.ground_truth()
        for mod, poses in ((TD, gt), (JD, [JPose(p.quat, p.tr, p.timestamp,
                                                 p.frame_id) for p in gt])):
            s = mod.Dataset.load_dataset(mod.DatasetOptions(
                dataset=mod.DatasetEnum.PLY_DIRECTORY,
                root_path=str(frames_dir))).sequences[0]
            s.set_ground_truth(poses)
            seqs.append(s)
    trun, jrun = _runners(tmp_path / "out")
    _keep_odometry(trun)
    tres = trun.run_sequence(seqs[0], driving=False)
    from ct_icp_tpu.odometry.odometry import Odometry as JOdometry
    jodo = JOdometry(jrun.config.odometry_options)
    jres = jrun.run_sequence(seqs[1], driving=False, odometry=jodo)
    assert tres.success and jres.success
    assert tres.num_frames == jres.num_frames == N[source]
    assert tres.finished == jres.finished
    d_m, d_deg = end_gap(trun._last_odometry.get_trajectory(),
                         jodo.get_trajectory())
    assert d_m < ACROSS[0] and d_deg < ACROSS[1], (d_m, d_deg)
    assert abs(tres.metrics.mean_ape - jres.metrics.mean_ape) < ACROSS[0]
    assert tres.metrics.mean_ape < 0.3
    assert (tres.trajectory_metrics is None) == \
        (jres.trajectory_metrics is None)
    name = seqs[0].seq_info.sequence_name
    _check_outputs(tmp_path / "out" / "port" / name, name, trun, tres,
                   tmp_path)
    trun.results[name] = tres
    trun._write_metrics_yaml()
    text = (tmp_path / "out" / "port" / "metrics.yaml").read_text()
    parsed = load_yaml(text)
    assert parsed[name]["MEAN_APE"] == tres.metrics.mean_ape
    if tres.trajectory_metrics is not None:
        assert parsed[f"{name}_trajectory"]["MEAN_ATE"] == \
            tres.trajectory_metrics.mean_ate


def test_degenerate_frame(tmp_path):
    """An all-NaN frame mid-sequence fails the sequence (in both packages
    at the same frame) but the runner survives with the prefix."""
    results = []
    for mod, acq, runner in zip((TD, JD), acquisitions(29),
                                _runners(tmp_path / "out")):
        class Broken(mod.SyntheticSequence):
            count = 0

            def next_frame(self):
                fr = super().next_frame()
                if self.count == 3:
                    fr["xyz"] = np.full_like(fr["xyz"], np.nan)
                self.count += 1
                return fr

        seq = Broken(acq)
        seq.set_max_num_frames(8)
        results.append(runner.run_sequence(seq, driving=False))
    t, j = results
    assert not t.success and not j.success
    assert t.num_frames == j.num_frames and 0 < t.num_frames <= 8
    for pkg in ("port", "ref"):
        assert (tmp_path / "out" / pkg / "Synthetic Scene"
                / "trajectory.ply").exists()
