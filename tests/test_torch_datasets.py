"""The port's dataset readers (``ct_icp_torch/datasets/dataset.py``)
against ct_icp_tpu's on files this test writes: PLY directories, the KITTI
filter, calibrations, ground truth and discovery, the NCLT stream and
ground truth, the synthetic sequence, the HILTI and TUM readers. Every
array the two give must be equal, bit for bit."""

import struct

import numpy as np
import pytest

from ct_icp_torch.datasets import dataset as TD
from ct_icp_torch.datasets import synthetic as tsyn
from ct_icp_torch.io.ply import write_ply_xyzt
from ct_icp_torch.io.trajectory_io import save_poses_kitti_format
from ct_icp_torch.core.pose import Pose
from ct_icp_tpu.datasets import dataset as JD
from ct_icp_tpu.datasets import synthetic as jsyn

PKGS = (TD, JD)


def _same_frame(a, b):
    assert set(a) == set(b)
    np.testing.assert_array_equal(a["xyz"], b["xyz"])
    if a.get("timestamps") is None:
        assert b.get("timestamps") is None
    else:
        np.testing.assert_array_equal(a["timestamps"], b["timestamps"])
    for k in ("begin_pose", "end_pose"):
        if a.get(k) is None:
            assert b.get(k) is None
        else:
            np.testing.assert_array_equal(a[k].quat, b[k].quat)
            np.testing.assert_array_equal(a[k].tr, b[k].tr)
            assert a[k].timestamp == b[k].timestamp


def _same_poses(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p.quat, q.quat)
        np.testing.assert_array_equal(p.tr, q.tr)
        assert (p.timestamp, p.frame_id) == (q.timestamp, q.frame_id)


def _ply_frames(frames_dir, n, points=50, seed=0):
    rng = np.random.default_rng(seed)
    frames_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        write_ply_xyzt(frames_dir / f"frame_{i:06d}.ply",
                       rng.normal(scale=20, size=(points, 3)),
                       np.linspace(i, i + 0.1, points))


class TestPLYDirectory:
    def test_iterate_and_random_access(self, tmp_path):
        _ply_frames(tmp_path / "frames", 4)
        t, j = TD.PLYDirectory(tmp_path / "frames"), \
            JD.PLYDirectory(tmp_path / "frames")
        assert t.num_frames() == j.num_frames() == 4
        assert t.with_random_access() and j.with_random_access()
        for a, b in zip(list(t), list(j)):
            _same_frame(a, b)
        _same_frame(t.get_frame(2), j.get_frame(2))

    def test_init_and_max_frames(self, tmp_path):
        _ply_frames(tmp_path / "frames", 6, points=5)
        seqs = [m.PLYDirectory(tmp_path / "frames") for m in PKGS]
        for s in seqs:
            s.set_init_frame(2)
            s.set_max_num_frames(3)
        t, j = (list(s) for s in seqs)
        assert len(t) == len(j) == 3
        for a, b in zip(t, j):
            _same_frame(a, b)

    def test_ground_truth_interpolates_frame_poses(self, tmp_path):
        _ply_frames(tmp_path / "frames", 3, points=8)
        gt = [Pose(tr=np.array([i * 0.5, 0.1 * i, 0.0]), timestamp=float(i))
              for i in range(4)]
        seqs = [m.PLYDirectory(tmp_path / "frames") for m in PKGS]
        for s in seqs:
            s.set_ground_truth(gt)
        for a, b in zip(list(seqs[0]), list(seqs[1])):
            _same_frame(a, b)


class TestKittiBits:
    def test_frame_filter(self):
        rng = np.random.default_rng(7)
        xyz = rng.uniform(-40, 40, (500, 3))
        xyz[:, 2] = rng.uniform(-8, 4, 500)
        np.testing.assert_array_equal(TD.kitti_frame_filter(xyz),
                                      JD.kitti_frame_filter(xyz))

    @pytest.mark.parametrize("sid", [0, 2, 3, 4, 21])
    def test_calibrations(self, sid):
        np.testing.assert_array_equal(TD.kitti_calib(sid),
                                      JD.kitti_calib(sid))
        for name in ("_KITTI_360_CALIB", "_NCLT_CALIB", "_HILTI_2021_CALIB",
                     "_HILTI_2022_CALIB"):
            np.testing.assert_array_equal(getattr(TD, name),
                                          getattr(JD, name))

    @pytest.mark.parametrize("ds", ["KITTI", "KITTI_raw", "KITTI_360",
                                    "KITTI_CARLA"])
    def test_gt_loader(self, tmp_path, ds):
        rng = np.random.default_rng(1)
        poses = []
        for i in range(6):
            q = rng.normal(size=4)
            poses.append(Pose(q / np.linalg.norm(q), rng.normal(size=3) * 9))
        name = "00"
        fname = "poses_gt.txt" if ds == "KITTI_CARLA" else f"{name}.txt"
        save_poses_kitti_format(tmp_path / fname, poses)
        t = TD.load_kitti_gt(tmp_path, name, 0, TD.DatasetEnum[ds])
        j = JD.load_kitti_gt(tmp_path, name, 0, JD.DatasetEnum[ds])
        _same_poses(t, j)

    @pytest.mark.parametrize("ds", ["KITTI", "KITTI_raw", "KITTI_360",
                                    "KITTI_CARLA"])
    def test_dataset_discovery(self, tmp_path, ds):
        names = {"KITTI_360": "03", "KITTI_CARLA": "Town02"}
        name = names.get(ds, "04")
        _ply_frames(tmp_path / name / "frames", 2, points=9)
        save_poses_kitti_format(
            tmp_path / name / ("poses_gt.txt" if ds == "KITTI_CARLA"
                               else f"{name}.txt"),
            [Pose(tr=np.array([float(i), 0, 0])) for i in range(2)])
        t, j = (m.Dataset.load_dataset(m.DatasetOptions(
            dataset=m.DatasetEnum[ds], root_path=str(tmp_path)))
            for m in PKGS)
        assert t.has_sequence(name) and j.has_sequence(name)
        st, sj = t.sequence(name), j.sequence(name)
        assert vars(st.seq_info) == vars(sj.seq_info)
        _same_poses(st.ground_truth(), sj.ground_truth())
        for a, b in zip(list(st), list(sj)):
            _same_frame(a, b)


def _write_hits(path, batches):
    with open(path, "wb") as f:
        for utime, pts in batches:
            f.write(struct.pack("<4H", 44444, 44444, 44444, 44444))
            f.write(struct.pack("<IQI", len(pts), utime, 0))
            for p in pts:
                enc = ((np.asarray(p) + 100.0) / 0.005).astype(np.uint16)
                f.write(struct.pack("<3H2B", *enc, 0, 0))


class TestNCLT:
    @pytest.mark.parametrize("native", [False, True])
    def test_decode_and_skip(self, tmp_path, native):
        from ct_icp_torch.io import native as tnative
        if native and not tnative.available():
            pytest.skip("no C++ compiler: the port decodes NCLT in Python")
        d = tmp_path / "2012-01-08_vel" / "2012-01-08"
        d.mkdir(parents=True)
        rng = np.random.default_rng(3)
        _write_hits(d / "velodyne_hits.bin", [
            (1000 + i, rng.uniform(-50, 50, (int(rng.integers(1, 9)), 3)))
            for i in range(10)])
        seqs = [m.NCLTIterator(tmp_path, "2012-01-08", num_aggregated_pc=3)
                for m in PKGS]
        if not native:
            seqs[0]._native = None
        seqs[1]._native = None       # the reference's pure-Python decode
        for s in seqs:
            s.set_init_frame(1)
        for _ in range(2):
            _same_frame(seqs[0].next_frame(), seqs[1].next_frame())

    def test_gt_parsing(self, tmp_path):
        csv = tmp_path / "gt.csv"
        rng = np.random.default_rng(4)
        rows = ["%.6f,%r,%r,%r,%r,%r,%r" % (1000 + i, *rng.normal(size=6))
                for i in range(5)]
        rows.insert(2, "1002.5,nan,0,0,0,0,0")
        csv.write_text("\n".join(rows))
        t, j = TD.read_nclt_poses(csv), JD.read_nclt_poses(csv)
        _same_poses(t, j)
        _same_poses(TD.conjugate_poses(t, TD._NCLT_CALIB),
                    JD.conjugate_poses(j, JD._NCLT_CALIB))

    def test_discovery_with_gt(self, tmp_path):
        name = "2012-01-15"
        d = tmp_path / f"{name}_vel" / name
        d.mkdir(parents=True)
        _write_hits(d / "velodyne_hits.bin",
                    [(2000 + i, [[1.0, 2.0, 3.0]]) for i in range(4)])
        (d / f"groundtruth_{name}.csv").write_text(
            "\n".join(f"{2000 + i},{i}.0,0,0,0,0,0.{i}" for i in range(4)))
        t, j = (m.Dataset.load_dataset(m.DatasetOptions(
            dataset=m.DatasetEnum.NCLT, root_path=str(tmp_path),
            nclt_num_aggregated_pc=2)) for m in PKGS)
        st, sj = t.sequence(name), j.sequence(name)
        st._native = sj._native = None
        _same_poses(st.ground_truth(), sj.ground_truth())
        _same_frame(st.next_frame(), sj.next_frame())


class TestSyntheticSequence:
    def test_sequence_api(self):
        seqs = []
        for syn, mod in ((tsyn, TD), (jsyn, JD)):
            scene = syn.Scene(syn.box_room(8.0, 4.0))
            traj = syn.circular_trajectory(radius=4.0, num_poses=50,
                                           total_time=1.0)
            acq = syn.SyntheticSensorAcquisition(
                scene, traj,
                syn.SyntheticAcquisitionOptions(num_points_per_frame=500),
                seed=1)
            seqs.append(mod.SyntheticSequence(acq))
        t, j = seqs
        assert t.num_frames() == j.num_frames()
        _same_poses(t.ground_truth(), j.ground_truth())
        for s in seqs:
            s.set_init_frame(2)
            s.set_max_num_frames(3)
        for a, b in zip(list(t), list(j)):
            _same_frame(a, b)

    def test_from_yaml(self):
        t, j = (m.Dataset.load_dataset(m.DatasetOptions(
            dataset=m.DatasetEnum.SYNTHETIC,
            root_path="configs/synthetic_courtyard.yaml")).sequences[0]
            for m in PKGS)
        assert t.seq_info.sequence_name == j.seq_info.sequence_name
        _same_frame(t.get_frame(3), j.get_frame(3))


TUM = ("# timestamp tx ty tz qx qy qz qw\n"
       "0.0 0.0 0.0 0.0 0.0 0.0 0.0 1.0\n"
       "\n"
       "0.1 1.0 2.0 3.0 0.0 0.0 0.0 1.0\n"
       "0.2 2.0 4.0 6.0 0.0 0.0 0.7071068 0.7071068 extra\n")


class TestHILTI:
    def test_tum_reader(self, tmp_path):
        (tmp_path / "gt.txt").write_text(TUM)
        _same_poses(TD.read_tum_poses(tmp_path / "gt.txt"),
                    JD.read_tum_poses(tmp_path / "gt.txt"))

    @pytest.mark.parametrize("ds", ["HILTI_2021", "HILTI_2022"])
    def test_gt_conjugation(self, tmp_path, ds):
        (tmp_path / "03.txt").write_text(TUM)
        _same_poses(TD.load_hilti_gt(tmp_path, "03", TD.DatasetEnum[ds]),
                    JD.load_hilti_gt(tmp_path, "03", JD.DatasetEnum[ds]))

    def test_hilti_discovery(self, tmp_path):
        _ply_frames(tmp_path / "03" / "frames", 2, points=4)
        (tmp_path / "03" / "gt.txt").write_text(TUM)
        t, j = (m.Dataset.load_dataset(m.DatasetOptions(
            dataset=m.DatasetEnum.HILTI_2021, root_path=str(tmp_path)))
            for m in PKGS)
        assert t.has_sequence("03") and j.has_sequence("03")
        _same_poses(t.sequence("03").ground_truth(),
                    j.sequence("03").ground_truth())
        _same_frame(t.sequence("03").next_frame(),
                    j.sequence("03").next_frame())

    def test_missing_sequences_fail_when_asked(self, tmp_path):
        for m in PKGS:
            with pytest.raises(FileNotFoundError):
                m.Dataset.load_dataset(m.DatasetOptions(
                    dataset=m.DatasetEnum.HILTI_2022,
                    root_path=str(tmp_path), fail_if_incomplete=True))
