"""Schema-driven conversions between numpy structured arrays and frames;
the port's own copy of ``ct_icp_tpu/io/structured.py`` (host numpy).

The transport-agnostic analog of the reference's ROSCore PointCloud2
conversion layer (reference ros/roscore/src/pc2_conversion.cxx,
include/ROSCore/point_types.h): a sensor message arrives as one packed
byte buffer with named, typed, offset fields — here a numpy structured
array, the in-Python equivalent of a PointCloud2 — and the odometry wants
``xyz`` float32 [N, 3] plus per-point timestamps.

Like the reference's ``ROSCloud2ToSlamPointCloudShallow``, the conversion
is zero-copy whenever the field layout allows a strided view (x, y, z
adjacent floats of the same dtype), and falls back to a gathering copy
otherwise.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

# field-name aliases accepted for each logical channel (the reference's
# XYZTPoint conventions plus common LiDAR sensor field names)
XYZ_NAMES = ("x", "y", "z")
TIME_NAMES = ("timestamp", "time", "t", "stamp", "time_offset")
INTENSITY_NAMES = ("intensity", "i", "reflectivity")


def _xyz_view_or_copy(arr: np.ndarray) -> np.ndarray:
    """[N, 3] float view of adjacent x/y/z fields when the memory layout
    allows it (same dtype, consecutive offsets), else a copy."""
    dt = arr.dtype
    # dtype.fields[name] is (field_dtype, offset[, title])
    off_x, off_y, off_z = (dt.fields[n][1] for n in XYZ_NAMES)
    base = dt.fields["x"][0]
    sz = base.itemsize
    if (off_y == off_x + sz and off_z == off_y + sz
            and all(dt.fields[n][0] == base for n in XYZ_NAMES)):
        view = np.ndarray(buffer=arr, dtype=base,
                          shape=(arr.shape[0], 3),
                          offset=off_x,
                          strides=(dt.itemsize, sz))
        return view
    return np.stack([arr[n] for n in XYZ_NAMES], axis=-1)


def structured_to_frame(arr: np.ndarray,
                        time_field: Optional[str] = None
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Structured point array -> (xyz [N,3], timestamps [N] or None).

    xyz is a zero-copy strided view when x/y/z are adjacent same-dtype
    fields (the shallow conversion of pc2_conversion.cxx); timestamps come
    from the first recognized time field (or ``time_field``).
    """
    if arr.dtype.names is None:
        a = np.asarray(arr)
        if a.ndim == 2 and a.shape[1] >= 3:
            return a[:, :3], None
        raise ValueError("expected a structured array or [N, >=3] array")
    names = arr.dtype.names
    for n in XYZ_NAMES:
        if n not in names:
            raise ValueError(f"missing point field {n!r}; have {names}")
    xyz = _xyz_view_or_copy(arr)
    ts = None
    candidates = (time_field,) if time_field else TIME_NAMES
    for n in candidates:
        if n and n in names:
            ts = np.asarray(arr[n], dtype=np.float64)
            break
    return xyz, ts


def frame_to_structured(xyz: np.ndarray,
                        timestamps: Optional[np.ndarray] = None,
                        extra: Optional[Mapping[str, np.ndarray]] = None,
                        ) -> np.ndarray:
    """(xyz, timestamps, extra channels) -> one packed structured array
    (the publication direction: SlamPointCloudToROSCloud2 analog)."""
    fields = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    if timestamps is not None:
        fields.append(("timestamp", np.float64))
    extra = dict(extra or {})
    for name, col in extra.items():
        fields.append((name, np.asarray(col).dtype))
    out = np.empty(xyz.shape[0], dtype=np.dtype(fields))
    out["x"], out["y"], out["z"] = (np.asarray(xyz[:, i], np.float32)
                                    for i in range(3))
    if timestamps is not None:
        out["timestamp"] = np.asarray(timestamps, np.float64)
    for name, col in extra.items():
        out[name] = col
    return out


def select_fields(arr: np.ndarray, names: Sequence[str]) -> np.ndarray:
    """Columnar projection of a structured array (schema mapper analog)."""
    return np.stack([np.asarray(arr[n], np.float64) for n in names], axis=-1)
