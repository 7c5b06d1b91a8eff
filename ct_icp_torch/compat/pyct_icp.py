"""pyct_icp — compatibility shim exposing the reference binding's API names;
the port's counterpart of ``ct_icp_tpu/compat/pyct_icp.py``.

The reference ships a pybind11 module ``pyct_icp``
(reference src/binding/pyct_icp/pyct_icp.cpp — broken against its own current
API, readme.md:259). This engine is Python-native, so the binding surface is
just an alias layer: users of the reference binding find the same names
(LiDARFrame, Odometry, OdometryOptions, RegistrationSummary, the enums and
profiles) backed by the PyTorch / CUDA implementation. ``Odometry`` runs on
the card unless ``device`` names another; with no card it raises.

    import ct_icp_torch.compat.pyct_icp as pyct_icp
    options = pyct_icp.OdometryOptions.DefaultDrivingProfile()
    odometry = pyct_icp.Odometry(options)
    summary = odometry.RegisterFrame(frame)
"""

from __future__ import annotations

import numpy as np

from ct_icp_torch.config import options as _opts
from ct_icp_torch.config.options import (CTICPOptions, MotionCompensation,
                                         Initialization, IcpDistance,
                                         LeastSquares,
                                         Solver as CT_ICP_SOLVER_ENUM)
from ct_icp_torch.odometry.odometry import Odometry as _Odometry
from ct_icp_torch.odometry.odometry import RegistrationSummary

# ------------------------------------------------------------------- enums —
CT_ICP_SOLVER = CT_ICP_SOLVER_ENUM
ICP_DISTANCE = IcpDistance
LEAST_SQUARES = LeastSquares
MOTION_COMPENSATION = MotionCompensation
INITIALIZATION = Initialization

GN = CT_ICP_SOLVER_ENUM.GN
CERES = CT_ICP_SOLVER_ENUM.CERES
ROBUST = CT_ICP_SOLVER_ENUM.ROBUST
POINT_TO_PLANE = IcpDistance.POINT_TO_PLANE
POINT_TO_POINT = IcpDistance.POINT_TO_POINT
POINT_TO_LINE = IcpDistance.POINT_TO_LINE
POINT_TO_DISTRIBUTION = IcpDistance.POINT_TO_DISTRIBUTION
NONE = MotionCompensation.NONE
CONSTANT_VELOCITY = MotionCompensation.CONSTANT_VELOCITY
ITERATIVE = MotionCompensation.ITERATIVE
CONTINUOUS = MotionCompensation.CONTINUOUS

# the structured per-point dtype of the reference binding's LiDARFrame
POINT3D_DTYPE = np.dtype([
    ("raw_point", np.float64, (3,)),
    ("pt", np.float64, (3,)),
    ("alpha_timestamp", np.float64),
    ("timestamp", np.float64),
    ("frame_index", np.int32),
])


class LiDARFrame:
    """numpy-structured-array frame wrapper (reference pyct_icp.cpp LiDARFrame)."""

    def __init__(self, n: int = 0):
        self.points = np.zeros(n, dtype=POINT3D_DTYPE)

    def SetFrame(self, array: np.ndarray):
        assert array.dtype == POINT3D_DTYPE
        self.points = np.ascontiguousarray(array)

    def GetStructuredArrayRef(self) -> np.ndarray:
        return self.points

    def GetWrappingArray(self) -> np.ndarray:
        return self.points

    @staticmethod
    def from_xyz(xyz: np.ndarray, timestamps=None) -> "LiDARFrame":
        f = LiDARFrame(xyz.shape[0])
        f.points["raw_point"] = xyz
        f.points["pt"] = xyz
        if timestamps is not None:
            f.points["timestamp"] = timestamps
        return f


class OdometryOptions:
    """Factory namespace mirroring the reference binding."""

    @staticmethod
    def DefaultDrivingProfile() -> _opts.OdometryOptions:
        return _opts.default_driving_profile()

    @staticmethod
    def RobustDrivingProfile() -> _opts.OdometryOptions:
        return _opts.robust_driving_profile()

    @staticmethod
    def DefaultRobustOutdoorLowInertia() -> _opts.OdometryOptions:
        return _opts.default_robust_outdoor_low_inertia()

    def __new__(cls) -> _opts.OdometryOptions:  # OdometryOptions() works too
        return _opts.OdometryOptions()


class Odometry:
    """Reference-binding-shaped odometry wrapper."""

    def __init__(self, options=None, device=None):
        self._odometry = _Odometry(options or _opts.OdometryOptions(),
                                   device=device)

    def RegisterFrame(self, frame: LiDARFrame) -> RegistrationSummary:
        pts = frame.points
        return self._odometry.register_frame(
            np.asarray(pts["raw_point"], np.float64),
            np.asarray(pts["timestamp"], np.float64))

    def RegisterFrameRaw(self, xyz: np.ndarray, timestamps: np.ndarray
                         ) -> RegistrationSummary:
        return self._odometry.register_frame(xyz, timestamps)

    def Trajectory(self):
        return self._odometry.get_trajectory()

    def MapSize(self) -> int:
        return self._odometry.map_size()

    def GetLocalMap(self) -> np.ndarray:
        return self._odometry.get_map_points(0)

    def Reset(self, options=None):
        self._odometry.reset(options)


# --------------------------------------------------------- dataset surface —
# (reference pyct_icp.cpp:270-301: DatasetOptions / DatasetSequence class
# bindings + the module-level dataset helper functions)

from ct_icp_torch.core.pose import Pose, TrajectoryFrame  # noqa: E402
from ct_icp_torch.datasets.dataset import (DatasetOptions,  # noqa: E402
                                           Dataset as _Dataset,
                                           SequenceInfo)


class DatasetSequence:
    """Reference-binding-shaped iterator over one dataset sequence."""

    def __init__(self, sequence):
        self._seq = sequence

    def HasNext(self) -> bool:
        return self._seq.has_next()

    def Next(self) -> LiDARFrame:
        fr = self._seq.next_frame()
        return LiDARFrame.from_xyz(fr["xyz"], fr.get("timestamps"))

    def NumFrames(self) -> int:
        return self._seq.num_frames()

    def WithRandomAccess(self) -> bool:
        return self._seq.with_random_access()

    def Frame(self, index_frame: int) -> LiDARFrame:
        assert self._seq.with_random_access(), \
            "Random Access is not available for the dataset"
        fr = self._seq.get_frame(index_frame)
        return LiDARFrame.from_xyz(fr["xyz"], fr.get("timestamps"))


def sequence_name(options: DatasetOptions, sequence_id: int) -> str:
    """Reference ct_icp::sequence_name."""
    ds = _Dataset.load_dataset(options)
    return ds.sequences[sequence_id].seq_info.sequence_name


def get_sequences(options: DatasetOptions):
    """Reference ct_icp::get_sequences: the SequenceInfos on disk."""
    ds = _Dataset.load_dataset(options)
    return [s.seq_info for s in ds.sequences]


def has_ground_truth(options: DatasetOptions, sequence_name: str) -> bool:
    """Reference ct_icp::has_ground_truth."""
    ds = _Dataset.load_dataset(options)
    return (ds.has_sequence(sequence_name)
            and ds.sequence(sequence_name).has_ground_truth())


def get_dataset_sequence(options: DatasetOptions,
                         sequence_name: str) -> DatasetSequence:
    """Reference ct_icp::get_dataset_sequence."""
    ds = _Dataset.load_dataset(options)
    return DatasetSequence(ds.sequence(sequence_name))


def load_sensor_ground_truth(options: DatasetOptions, sequence_name: str):
    """Reference ct_icp::load_sensor_ground_truth (GT in the sensor frame)."""
    ds = _Dataset.load_dataset(options)
    gt = ds.sequence(sequence_name).ground_truth()
    if gt is None:
        raise ValueError(f"no ground truth for sequence {sequence_name}")
    return gt


# the reference aliases load_ground_truth to the sensor-frame loader
# (pyct_icp.cpp:300)
load_ground_truth = load_sensor_ground_truth
