"""Dataset readers: KITTI family, NCLT, HILTI, PLY directories, synthetic.

Python counterpart of the reference dataset layer
(reference include/ct_icp/dataset.h, src/ct_icp/dataset.cpp): sequence
discovery, per-dataset directory layouts, hardcoded extrinsic calibrations,
ground-truth loaders with calibration conjugation, the KITTI vertical-angle
frame filter, and the NCLT velodyne_hits.bin stream decoder (vectorized with
numpy instead of the reference's per-point loop).

Host copy of ``ct_icp_tpu/datasets/dataset.py`` (numpy only, nothing of the
JAX package imported): the same files give the same arrays, bit for bit.
The SYNTHETIC dataset wraps the port's acquisition
(``config/yaml_config.py::synthetic_sequence_from_yaml``).

A Frame is a plain dict: {"xyz" [N,3] float64 sensor-frame points,
"timestamps" [N] or None, "begin_pose"/"end_pose" Optional[Pose],
"file_path" str}.
"""

from __future__ import annotations

import dataclasses
import enum
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.pose import Pose
from ct_icp_torch.core.trajectory import LinearContinuousTrajectory
from ct_icp_torch.io.ply import read_ply_xyzt
from ct_icp_torch.io.trajectory_io import load_poses_kitti_format


class DatasetEnum(enum.Enum):
    KITTI_raw = "KITTI_raw"
    KITTI_CARLA = "KITTI_CARLA"
    KITTI = "KITTI"
    KITTI_360 = "KITTI_360"
    NCLT = "NCLT"
    HILTI_2021 = "HILTI_2021"
    HILTI_2022 = "HILTI_2022"
    PLY_DIRECTORY = "PLY_DIRECTORY"
    SYNTHETIC = "SYNTHETIC"
    CUSTOM = "CUSTOM"


def dataset_from_string(name: str) -> DatasetEnum:
    return DatasetEnum[name]


def is_driving_dataset(dataset: DatasetEnum) -> bool:
    return dataset in (DatasetEnum.KITTI, DatasetEnum.KITTI_raw,
                       DatasetEnum.KITTI_360, DatasetEnum.KITTI_CARLA)


@dataclasses.dataclass
class DatasetOptions:
    """Reference DatasetOptions (dataset.h / config.cpp:264-301)."""

    dataset: DatasetEnum = DatasetEnum.PLY_DIRECTORY
    root_path: str = ""
    fail_if_incomplete: bool = False
    min_dist_lidar_center: float = 3.0
    max_dist_lidar_center: float = 100.0
    nclt_num_aggregated_pc: int = 220
    use_all_datasets: bool = False
    sequence_options: List[Dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SequenceInfo:
    """Reference SequenceInfo (dataset.h:38-50)."""

    sequence_name: str = ""
    label: str = ""
    sequence_id: int = -1
    sequence_size: int = -1
    with_ground_truth: bool = False


# --------------------------------------------------- KITTI hardcoded tables —
# (reference src/ct_icp/dataset.cpp:21-120; public KITTI devkit calibrations)

KITTI_SEQUENCE_NAMES = [f"{i:02d}" for i in range(22)]
KITTI_SEQUENCES_SIZE = [4540, 1100, 4660, 800, 270, 2760, 1100, 1100, 4070,
                        1590, 1200, 920, 1060, 3280, 630, 1900, 1730, 490,
                        1800, 4980, 830, 2720]

_KITTI_CALIB_A = np.array([
    [4.276802385584e-04, -9.999672484946e-01, -8.084491683471e-03, -1.198459927713e-02],
    [-7.210626507497e-03, 8.081198471645e-03, -9.999413164504e-01, -5.403984729748e-02],
    [9.999738645903e-01, 4.859485810390e-04, -7.206933692422e-03, -2.921968648686e-01],
    [0, 0, 0, 1]])
_KITTI_CALIB_B = np.array([
    [2.347736981471e-04, -9.999441545438e-01, -1.056347781105e-02, -2.796816941295e-03],
    [1.044940741659e-02, 1.056535364138e-02, -9.998895741176e-01, -7.510879138296e-02],
    [9.999453885620e-01, 1.243653783865e-04, 1.045130299567e-02, -2.721327964059e-01],
    [0, 0, 0, 1]])
_KITTI_CALIB_C = np.array([
    [-1.857739385241e-03, -9.999659513510e-01, -8.039975204516e-03, -4.784029760483e-03],
    [-6.481465826011e-03, 8.051860151134e-03, -9.999466081774e-01, -7.337429464231e-02],
    [9.999773098287e-01, -1.805528627661e-03, -6.496203536139e-03, -3.339968064433e-01],
    [0, 0, 0, 1]])


def kitti_calib(sequence_id: int) -> np.ndarray:
    """Velodyne->camera extrinsics per sequence (dataset.cpp:75-84)."""
    if sequence_id <= 2:
        return _KITTI_CALIB_A
    if sequence_id == 3:
        return _KITTI_CALIB_B
    return _KITTI_CALIB_C


KITTI_360_SEQUENCE_NAMES = ["00", "02", "03", "04", "05", "06", "07", "09", "10"]
KITTI_360_SEQUENCES_SIZE = [11500, 19230, 1029, 11399, 6722, 9697, 3160, 13954, 3742]

_KITTI_360_CALIB = np.eye(4)
_KITTI_360_CALIB[:3, :3] = np.array([
    [9.999290633685804508e-01, 5.805355888196038310e-03, 1.040029024212630118e-02],
    [5.774300279226996999e-03, -9.999787876452227442e-01, 3.013573682642321436e-03],
    [1.041756443854582707e-02, -2.953305511449066945e-03, -9.999413744330052367e-01]])
_KITTI_360_CALIB[:3, 3] = [-7.640302229235816922e-01, 2.966030253893782165e-01,
                           -8.433819635885287935e-01]

KITTI_CARLA_SEQUENCE_NAMES = [f"Town{i:02d}" for i in range(1, 8)]

NCLT_SEQUENCE_NAMES = [
    "2012-01-08", "2012-01-15", "2012-01-22", "2012-02-02", "2012-02-04",
    "2012-02-05", "2012-02-12", "2012-02-18", "2012-02-19", "2012-03-17",
    "2012-03-25", "2012-03-31", "2012-04-29", "2012-05-11", "2012-05-26",
    "2012-06-15", "2012-08-04", "2012-08-20", "2012-09-28", "2012-10-28",
    "2012-11-04", "2012-11-16", "2012-11-17", "2012-12-01", "2013-01-10",
    "2013-02-23", "2013-04-05"]


def _nclt_calib() -> np.ndarray:
    """Body->lidar extrinsics (dataset.cpp:186-200)."""
    d = np.eye(4)
    d[:3, 3] = [0.002, -0.004, -0.957]
    roll, pitch, yaw = np.deg2rad([0.807, 0.166, -90.703])
    rz = s3n.quat_to_matrix(s3n.quat_from_rotvec(np.array([0, 0, yaw])))
    ry = s3n.quat_to_matrix(s3n.quat_from_rotvec(np.array([0, pitch, 0])))
    rx = s3n.quat_to_matrix(s3n.quat_from_rotvec(np.array([roll, 0, 0])))
    d[:3, :3] = rz @ ry @ rx
    return d


_NCLT_CALIB = _nclt_calib()

HILTI_SEQUENCE_NAMES = [f"{i:02d}" for i in range(12)]
HILTI_SEQUENCES_SIZE = [895, 2004, 2641, 5824, 1130, 3308, 3503, 1357, 1995,
                        3992, 4298, 3749]


def kitti_frame_filter(xyz: np.ndarray) -> np.ndarray:
    """The KITTI HDL-64 intrinsic correction (dataset.cpp:85-111):
    drop points with z <= -5 (bad returns under the ground) and rotate every
    remaining point by 0.205 deg about (p x uz)."""
    keep = xyz[:, 2] > -5.0
    pts = xyz[keep]
    uz = np.array([0.0, 0.0, 1.0])
    axis = np.cross(pts, uz)
    norm = np.linalg.norm(axis, axis=-1, keepdims=True)
    axis = axis / np.maximum(norm, 1e-12)
    ang = np.deg2rad(0.205)
    q = s3n.quat_from_rotvec(axis * ang)
    return s3n.quat_rotate(q, pts)


# ----------------------------------------------------------------- sequences —

class ADatasetSequence:
    """Iterator API (reference dataset.h:54-122): frame filter, init frame,
    max frames, optional random access + ground truth."""

    def __init__(self, seq_info: SequenceInfo):
        self.seq_info = seq_info
        self.max_num_frames = -1
        self.init_frame_id = 0
        self.current_frame_id = 0
        self.filter: Optional[Callable] = None

    # iteration protocol -------------------------------------------------
    def has_next(self) -> bool:
        return False

    def num_frames(self) -> int:
        raise NotImplementedError

    def next_frame(self) -> Dict:
        frame = self._next_unfiltered()
        self._process(frame)
        return frame

    def skip_frame(self):
        assert self.has_next(), "Cannot skip frame. No more frames"
        self.current_frame_id += 1

    def get_frame(self, index: int) -> Dict:
        frame = self._get_unfiltered(index)
        self._process(frame)
        return frame

    def with_random_access(self) -> bool:
        return False

    def set_init_frame(self, frame_index: int):
        self.init_frame_id = frame_index
        self.current_frame_id = frame_index

    def set_max_num_frames(self, n: int):
        self.max_num_frames = n

    def ground_truth(self) -> Optional[List[Pose]]:
        return None

    def has_ground_truth(self) -> bool:
        return self.seq_info.with_ground_truth

    def __iter__(self):
        while self.has_next():
            yield self.next_frame()

    # internals ----------------------------------------------------------
    def _next_unfiltered(self) -> Dict:
        raise NotImplementedError

    def _get_unfiltered(self, index: int) -> Dict:
        raise RuntimeError("Random Access is not supported")

    def _process(self, frame: Dict):
        if self.filter is not None:
            frame["xyz"], frame["timestamps"] = self.filter(
                frame["xyz"], frame.get("timestamps"))


class AFileSequence(ADatasetSequence):
    """Random-access sequence over per-frame files (reference dataset.h:175-268)."""

    def __init__(self, root_path, filenames: Sequence[str],
                 seq_info: SequenceInfo):
        super().__init__(seq_info)
        self.root_path = Path(root_path)
        self.filenames = sorted(filenames)
        self.gt_trajectory: Optional[LinearContinuousTrajectory] = None

    def num_frames(self) -> int:
        return len(self.filenames)

    def with_random_access(self) -> bool:
        return True

    def has_next(self) -> bool:
        last = len(self.filenames)
        if self.max_num_frames > 0:
            last = min(last, self.init_frame_id + self.max_num_frames)
        return self.current_frame_id < last

    def set_ground_truth(self, poses: Sequence[Pose]):
        self.gt_trajectory = LinearContinuousTrajectory(poses)
        self.gt_poses = list(poses)
        self.seq_info.with_ground_truth = True

    def ground_truth(self) -> Optional[List[Pose]]:
        if self.gt_trajectory is None:
            return None
        return self.gt_poses

    def _next_unfiltered(self) -> Dict:
        frame = self._get_unfiltered(self.current_frame_id)
        self.current_frame_id += 1
        return frame

    def read_file(self, path: str) -> Dict:
        raise NotImplementedError

    def _get_unfiltered(self, index: int) -> Dict:
        path = str(self.root_path / self.filenames[index])
        frame = self.read_file(path)
        frame["file_path"] = path
        ts = frame.get("timestamps")
        if ts is not None and self.gt_trajectory is not None and len(ts):
            frame["begin_pose"] = self.gt_trajectory.interpolate_pose(float(ts.min()))
            frame["end_pose"] = self.gt_trajectory.interpolate_pose(float(ts.max()))
        return frame


class PLYDirectory(AFileSequence):
    """Directory of per-frame PLY files (reference PLYDirectory,
    dataset.cpp:773-840)."""

    def __init__(self, root_path, seq_info: Optional[SequenceInfo] = None,
                 filenames: Optional[Sequence[str]] = None):
        root = Path(root_path)
        if filenames is None:
            assert root.is_dir(), f"{root} is not a directory"
            filenames = [f.name for f in root.iterdir()
                         if f.is_file() and f.suffix.lower() == ".ply"]
        super().__init__(root, filenames,
                         seq_info or SequenceInfo(sequence_name="Unnamed Sequence"))

    def read_file(self, path: str) -> Dict:
        xyz, ts = read_ply_xyzt(path)
        return {"xyz": xyz, "timestamps": ts,
                "begin_pose": None, "end_pose": None}


class SyntheticSequence(ADatasetSequence):
    """Frames simulated from a synthetic scene + GT trajectory
    (reference SyntheticSequence, dataset.h:133-170)."""

    def __init__(self, acquisition, seq_info: Optional[SequenceInfo] = None):
        from ct_icp_torch.datasets.synthetic import SyntheticSensorAcquisition
        assert isinstance(acquisition, SyntheticSensorAcquisition)
        self.acq = acquisition
        n = acquisition.num_frames()
        # GT is expressed relative to the first pose (the odometry estimate
        # starts at identity) — same normalization as the reference synthetic
        # loader (dataset.cpp:716-719) and NCLT GT reader (dataset.cpp:374-376)
        first = acquisition.trajectory.poses[0]
        self._first_inv = first.inverse()
        super().__init__(seq_info or SequenceInfo(
            sequence_name="Synthetic Scene", sequence_size=n,
            with_ground_truth=True))

    def num_frames(self) -> int:
        return self.acq.num_frames()

    def with_random_access(self) -> bool:
        return True

    def has_next(self) -> bool:
        last = self.num_frames()
        if self.max_num_frames > 0:
            last = min(last, self.init_frame_id + self.max_num_frames)
        return self.current_frame_id < last

    def _rel(self, p: Pose) -> Pose:
        out = self._first_inv * p
        out.timestamp = p.timestamp
        return out

    def ground_truth(self) -> Optional[List[Pose]]:
        return [self._rel(p) for p in self.acq.trajectory.poses]

    def _next_unfiltered(self) -> Dict:
        frame = self._get_unfiltered(self.current_frame_id)
        self.current_frame_id += 1
        return frame

    def _get_unfiltered(self, index: int) -> Dict:
        frame = self.acq.frame(index)
        if frame.get("begin_pose") is not None:
            frame["begin_pose"] = self._rel(frame["begin_pose"])
        if frame.get("end_pose") is not None:
            frame["end_pose"] = self._rel(frame["end_pose"])
        return frame


class NCLTIterator(ADatasetSequence):
    """Streams NCLT ``velodyne_hits.bin`` (reference NCLTIterator,
    dataset.cpp:385-570): magic-number-delimited batches of uint16-encoded
    hits, ``num_aggregated_pc`` batches aggregated per frame, coordinates
    decoded as v*0.005 - 100, per-batch utime as the timestamp."""

    MAGIC = 44444

    def __init__(self, root_path, sequence_name: str,
                 num_aggregated_pc: int = 220,
                 seq_info: Optional[SequenceInfo] = None):
        super().__init__(seq_info or SequenceInfo(sequence_name=sequence_name))
        self.sequence_name = sequence_name
        self.num_aggregated_pc = num_aggregated_pc
        path = (Path(root_path) / f"{sequence_name}_vel" / sequence_name
                / "velodyne_hits.bin")
        assert path.exists(), f"The file {path} does not exist on disk"
        self._path = path
        self._file = open(path, "rb")
        self._eof = False
        self.gt_trajectory: Optional[LinearContinuousTrajectory] = None
        # native streaming decoder when the C++ layer is available
        self._native = None
        try:
            from ct_icp_torch.io.native import NcltNativeReader, available
            if available():
                self._native = NcltNativeReader(path)
        except Exception:
            self._native = None

    def set_ground_truth(self, poses: Sequence[Pose]):
        self.gt_trajectory = LinearContinuousTrajectory(poses)
        self.gt_poses = list(poses)
        self.seq_info.with_ground_truth = True

    def ground_truth(self) -> Optional[List[Pose]]:
        return getattr(self, "gt_poses", None)

    def num_frames(self) -> int:
        return self.max_num_frames

    def has_next(self) -> bool:
        if self._eof:
            return False
        if self.max_num_frames >= 0 and \
                self.current_frame_id >= self.max_num_frames + self.init_frame_id:
            return False
        return True

    def set_init_frame(self, frame_index: int):
        self.init_frame_id = frame_index
        self._file.seek(0)
        if self._native is not None:
            self._native.close()
            from ct_icp_torch.io.native import NcltNativeReader
            self._native = NcltNativeReader(self._path)
        self._eof = False
        self.current_frame_id = 0
        for _ in range(frame_index):
            self._read_frame(skip=True)

    def skip_frame(self):
        self._read_frame(skip=True)

    def _read_batch(self, skip: bool):
        header = self._file.read(24)
        if len(header) < 24:
            self._eof = True
            return None, None
        magic = np.frombuffer(header, dtype="<u2", count=4)
        if not np.all(magic == self.MAGIC):
            raise ValueError("The batch does not have a matching magic number")
        num_hits = int(np.frombuffer(header, dtype="<u4", count=1, offset=8)[0])
        utime = float(np.frombuffer(header, dtype="<u8", count=1, offset=12)[0])
        nbytes = 8 * num_hits  # 3x u2 xyz + 2x u1 intensity/laser
        if skip:
            self._file.seek(nbytes, 1)
            return None, utime
        buf = self._file.read(nbytes)
        if len(buf) < nbytes:
            self._eof = True
            return None, utime
        rec = np.frombuffer(buf, dtype=np.dtype(
            [("xyz", "<u2", (3,)), ("il", "u1", (2,))]))
        xyz = rec["xyz"].astype(np.float64) * 0.005 - 100.0
        return xyz, utime

    def _read_frame(self, skip: bool = False) -> Optional[Dict]:
        if self._native is not None:
            out = self._native.read(self.num_aggregated_pc, skip=skip)
            self.current_frame_id += 1
            if out is None:
                self._eof = True
                return None
            if skip:
                return None
            xyz, ts = out
            if xyz.shape[0] == 0:
                self._eof = True
                return None
            return self._finish_frame(xyz, ts)
        parts, times = [], []
        for _ in range(self.num_aggregated_pc):
            if self._eof:
                break
            xyz, utime = self._read_batch(skip)
            if utime is None:
                break
            if not skip and xyz is not None:
                parts.append(xyz)
                times.append(np.full(xyz.shape[0], utime))
        self.current_frame_id += 1
        if skip or not parts:
            return None
        xyz = np.concatenate(parts)
        ts = np.concatenate(times)
        return self._finish_frame(xyz, ts)

    def _finish_frame(self, xyz, ts) -> Dict:
        frame = {"xyz": xyz, "timestamps": ts,
                 "begin_pose": None, "end_pose": None}
        if self.gt_trajectory is not None:
            frame["begin_pose"] = self.gt_trajectory.interpolate_pose(float(ts.min()))
            frame["end_pose"] = self.gt_trajectory.interpolate_pose(float(ts.max()))
        return frame

    def _next_unfiltered(self) -> Dict:
        frame = self._read_frame(skip=False)
        if frame is None:
            raise StopIteration
        return frame


# -------------------------------------------------------------- GT loaders —

def read_nclt_poses(path) -> List[Pose]:
    """NCLT groundtruth csv -> poses relative to the first valid one
    (reference ReadNCLTPoses, dataset.cpp:319-381)."""
    poses: List[Pose] = []
    init_inv: Optional[Pose] = None
    data = np.genfromtxt(path, delimiter=",")
    for row in np.atleast_2d(data):
        if row.shape[0] < 7 or np.any(np.isnan(row)):
            continue
        ts, x, y, z, roll, pitch, yaw = row[:7]
        rz = s3n.quat_from_rotvec(np.array([0, 0, yaw]))
        ry = s3n.quat_from_rotvec(np.array([0, pitch, 0]))
        rx = s3n.quat_from_rotvec(np.array([roll, 0, 0]))
        q = s3n.quat_mul(rz, s3n.quat_mul(ry, rx))
        p = Pose(q, np.array([x, y, z]), timestamp=float(ts))
        if init_inv is None:
            init_inv = p.inverse()
            init_inv.timestamp = 0.0
        rel = init_inv * p
        rel.timestamp = float(ts)
        poses.append(rel)
    return poses


def read_tum_poses(path) -> List[Pose]:
    """TUM-format trajectory (timestamp x y z qx qy qz qw) — the HILTI GT
    format (reference ReadHILTIPosesInLidarFrame, dataset.cpp)."""
    poses = []
    for line in open(path):
        tok = line.split()
        if not tok or tok[0].startswith("#"):
            continue
        vals = [float(v) for v in tok[:8]]
        ts, x, y, z, qx, qy, qz, qw = vals
        poses.append(Pose(np.array([qw, qx, qy, qz]), np.array([x, y, z]),
                          timestamp=ts))
    return poses


_HILTI_2021_CALIB = np.eye(4)
_HILTI_2021_CALIB[:3, :3] = s3n.quat_to_matrix(s3n.quat_normalize(
    np.array([-0.00016947759535612024, 0.999993918507834,
              0.0012283821413574625, -0.0032596475280467258])))
_HILTI_2021_CALIB[:3, 3] = [0.01001966915517371, -0.006645473484212856,
                            0.09473042428051345]

_HILTI_2022_CALIB = np.eye(4)
_HILTI_2022_CALIB[:3, :3] = s3n.quat_to_matrix(s3n.quat_normalize(
    np.array([0.0, 0.7071068, -0.7071068, 0.0])))
_HILTI_2022_CALIB[:3, 3] = [-0.001, -0.00855, 0.055]


def load_hilti_gt(sequence_path: Path, sequence_name: str,
                  dataset: DatasetEnum) -> Optional[List[Pose]]:
    """HILTI GT in the lidar frame (calibration conjugation like the
    reference's ReadHILTIPosesInLidarFrame)."""
    for candidate in (sequence_path / f"{sequence_name}.txt",
                      sequence_path / "gt.txt",
                      sequence_path / "groundtruth.txt"):
        if candidate.exists():
            poses = read_tum_poses(candidate)
            calib = (_HILTI_2021_CALIB if dataset == DatasetEnum.HILTI_2021
                     else _HILTI_2022_CALIB)
            return conjugate_poses(poses, calib)
    return None


def conjugate_poses(poses: Sequence[Pose], calib: np.ndarray) -> List[Pose]:
    """GT calibration conjugation: Calib^-1 * P * Calib
    (reference dataset.cpp:1004-1029)."""
    calib_inv = np.linalg.inv(calib)
    out = []
    for p in poses:
        m = calib_inv @ p.matrix() @ calib
        np_ = Pose.from_matrix(m, p.timestamp, p.frame_id)
        out.append(np_)
    return out


def load_kitti_gt(sequence_path: Path, sequence_name: str, sequence_id: int,
                  dataset: DatasetEnum) -> Optional[List[Pose]]:
    """KITTI-format GT + calibration + synthetic mid-scan timestamps
    (reference LoadPoses, dataset.cpp:998-1098)."""
    gt_file = sequence_path / f"{sequence_name}.txt"
    if dataset == DatasetEnum.KITTI_CARLA:
        gt_file = sequence_path / "poses_gt.txt"
    if not gt_file.exists():
        return None
    poses = load_poses_kitti_format(gt_file)
    if dataset in (DatasetEnum.KITTI, DatasetEnum.KITTI_raw):
        calib = kitti_calib(sequence_id)
    elif dataset == DatasetEnum.KITTI_360:
        calib = _KITTI_360_CALIB
    else:
        calib = np.eye(4)
    poses = conjugate_poses(poses, calib)
    for i, p in enumerate(poses):
        if dataset in (DatasetEnum.KITTI, DatasetEnum.KITTI_raw,
                       DatasetEnum.KITTI_360):
            p.timestamp = (i + 0.5) * 0.1
        elif dataset == DatasetEnum.KITTI_CARLA:
            p.timestamp = i * 0.1
        p.frame_id = i
    return poses


# ------------------------------------------------------------------ factory —

def _kitti_filter(xyz, ts):
    keep = xyz[:, 2] > -5.0
    return kitti_frame_filter(xyz), (ts[keep] if ts is not None else None)


class Dataset:
    """Discovery + factory (reference Dataset::LoadDataset,
    dataset.cpp:1214-1260)."""

    def __init__(self, options: DatasetOptions,
                 sequences: List[ADatasetSequence]):
        self.options = options
        self.sequences = sequences

    @staticmethod
    def load_dataset(options: DatasetOptions) -> "Dataset":
        root = Path(options.root_path)
        ds = options.dataset
        sequences: List[ADatasetSequence] = []

        def add_ply_sequence(seq_dir: Path, name: str, sid: int,
                             expected: int = -1, kitti_like: bool = False):
            frames_dir = seq_dir / "frames"
            if not frames_dir.is_dir():
                if options.fail_if_incomplete:
                    raise FileNotFoundError(frames_dir)
                return
            info = SequenceInfo(sequence_name=name, label=name,
                                sequence_id=sid, sequence_size=expected)
            seq = PLYDirectory(frames_dir, info)
            if kitti_like:
                seq.filter = _kitti_filter
            gt = load_kitti_gt(seq_dir, name, sid, ds)
            if gt is not None:
                seq.set_ground_truth(gt)
            sequences.append(seq)

        if ds in (DatasetEnum.KITTI, DatasetEnum.KITTI_raw):
            names = (KITTI_SEQUENCE_NAMES if ds == DatasetEnum.KITTI
                     else [n for i, n in enumerate(KITTI_SEQUENCE_NAMES)
                           if i <= 10 and i != 3])
            for name in names:
                if (root / name).is_dir():
                    sid = int(name)
                    add_ply_sequence(root / name, name, sid,
                                     KITTI_SEQUENCES_SIZE[sid],
                                     kitti_like=(ds == DatasetEnum.KITTI_raw))
        elif ds == DatasetEnum.KITTI_360:
            for i, name in enumerate(KITTI_360_SEQUENCE_NAMES):
                if (root / name).is_dir():
                    add_ply_sequence(root / name, name, i,
                                     KITTI_360_SEQUENCES_SIZE[i])
        elif ds == DatasetEnum.KITTI_CARLA:
            for i, name in enumerate(KITTI_CARLA_SEQUENCE_NAMES):
                if (root / name).is_dir():
                    add_ply_sequence(root / name, name, i, 5000)
        elif ds in (DatasetEnum.HILTI_2021, DatasetEnum.HILTI_2022):
            for i, name in enumerate(HILTI_SEQUENCE_NAMES):
                if (root / name).is_dir():
                    add_ply_sequence(root / name, name, i,
                                     HILTI_SEQUENCES_SIZE[i])
                    # HILTI GT uses TUM format + lidar-frame conjugation
                    seq = sequences[-1] if sequences else None
                    if seq is not None and not seq.seq_info.with_ground_truth:
                        gt = load_hilti_gt(root / name, name, ds)
                        if gt is not None:
                            seq.set_ground_truth(gt)
        elif ds == DatasetEnum.NCLT:
            for i, name in enumerate(NCLT_SEQUENCE_NAMES):
                if (root / f"{name}_vel").is_dir():
                    info = SequenceInfo(sequence_name=name, label=name,
                                        sequence_id=i)
                    seq = NCLTIterator(root, name,
                                       options.nclt_num_aggregated_pc, info)
                    gt_csv = (root / name / f"groundtruth_{name}.csv")
                    if not gt_csv.exists():
                        gt_csv = (root / f"{name}_vel" / name
                                  / f"groundtruth_{name}.csv")
                    if gt_csv.exists():
                        poses = conjugate_poses(read_nclt_poses(gt_csv),
                                                _NCLT_CALIB)
                        seq.set_ground_truth(poses)
                    sequences.append(seq)
        elif ds == DatasetEnum.PLY_DIRECTORY:
            frames_dir = root / "frames"
            target = frames_dir if frames_dir.is_dir() else root
            sequences.append(PLYDirectory(target))
        elif ds == DatasetEnum.SYNTHETIC:
            from ct_icp_torch.config.yaml_config import synthetic_sequence_from_yaml
            sequences.append(SyntheticSequence(
                synthetic_sequence_from_yaml(options.root_path)))
        else:
            raise ValueError(f"Unsupported dataset {ds}")

        if options.fail_if_incomplete and not sequences:
            raise FileNotFoundError(
                f"No sequences found for {ds} under {root}")
        return Dataset(options, sequences)

    def has_sequence(self, name: str) -> bool:
        return any(s.seq_info.sequence_name == name for s in self.sequences)

    def sequence(self, name: str) -> ADatasetSequence:
        for s in self.sequences:
            if s.seq_info.sequence_name == name:
                return s
        raise KeyError(name)
