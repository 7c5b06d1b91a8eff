"""IMU measurement type (reference include/SlamCore/imu.h:12-43); the
port's own copy of ``ct_icp_tpu/core/imu.py``, the same record layout.

Kept as a plain numpy record array schema so IMU streams ride alongside scans
in dataset frames; the inertial fusion itself is future work (the reference's
binding is equally data-only: its ImuData is carried, not fused, in the open
pipeline).
"""

from __future__ import annotations

import dataclasses

import numpy as np

IMU_DTYPE = np.dtype([
    ("timestamp", np.float64),
    ("angular_velocity", np.float64, (3,)),
    ("linear_acceleration", np.float64, (3,)),
    ("orientation", np.float64, (4,)),   # (w, x, y, z); NaN when absent
])


@dataclasses.dataclass
class ImuData:
    timestamp: float = -1.0
    angular_velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    linear_acceleration: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    orientation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(4, np.nan))

    @staticmethod
    def pack(items) -> np.ndarray:
        out = np.zeros(len(items), dtype=IMU_DTYPE)
        for i, d in enumerate(items):
            out[i] = (d.timestamp, d.angular_velocity, d.linear_acceleration,
                      d.orientation)
        return out

    @staticmethod
    def unpack(arr: np.ndarray):
        return [ImuData(float(r["timestamp"]),
                        np.array(r["angular_velocity"]),
                        np.array(r["linear_acceleration"]),
                        np.array(r["orientation"])) for r in arr]
