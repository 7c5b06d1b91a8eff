"""Carry state across from ``ct_icp_tpu`` without importing it.

* :func:`map_state_from_numpy` builds the port's map from the reference's
  ``MapLevel`` fields given as numpy arrays (``win``, derived TPU probe
  layout, is dropped).
* :func:`options_from_dict` builds the port's ``OdometryOptions`` (or any
  options dataclass) from ``dataclasses.asdict`` of the reference's.

The parity tests use both so the two packages compute from the same state.
"""

import dataclasses
import enum
import typing

import numpy as np
import torch

from ct_icp_torch.config import options as opt
from ct_icp_torch.mapping.voxel_map import MapLevel

_LEVEL_FIELDS = ("keys", "count", "points", "normals", "nflags", "num_points")


def _fields(level):
    if isinstance(level, dict):
        return level
    if hasattr(level, "_asdict"):
        return level._asdict()
    return {f: getattr(level, f) for f in _LEVEL_FIELDS}


def map_state_from_numpy(levels, device="cpu"):
    """Sequence of levels (mappings or NamedTuples of array-likes with the
    reference MapLevel fields) -> tuple of port ``MapLevel``s on ``device``.
    uint32 keys keep their bit pattern as int32."""
    out = []
    for level in levels:
        f = _fields(level)
        keys = np.ascontiguousarray(np.asarray(f["keys"]).astype(np.uint32))
        out.append(MapLevel(
            keys=torch.tensor(keys.view(np.int32), device=device),
            count=torch.tensor(np.asarray(f["count"], np.int32),
                                  device=device),
            points=torch.tensor(np.asarray(f["points"], np.float32),
                                   device=device),
            normals=torch.tensor(np.asarray(f["normals"], np.float32),
                                    device=device),
            nflags=torch.tensor(np.asarray(f["nflags"], np.int32),
                                   device=device),
            num_points=torch.tensor(
                np.asarray(f["num_points"], np.int32).reshape(1),
                device=device)))
    return tuple(out)


def _build(tp, value):
    origin = typing.get_origin(tp)
    if origin is typing.Union:                      # Optional[X]
        if value is None:
            return None
        inner = [a for a in typing.get_args(tp) if a is not type(None)]
        return _build(inner[0], value)
    if origin in (tuple, list):
        args = typing.get_args(tp)
        item = args[0] if args else typing.Any
        return tuple(_build(item, v) for v in value)
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        return options_from_dict(value, tp)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp(getattr(value, "value", value))
    return value


def options_from_dict(d, cls=opt.OdometryOptions):
    """``dataclasses.asdict`` of a reference options object -> the port's
    ``cls`` (nested dataclasses and enums rebuilt by value)."""
    hints = typing.get_type_hints(cls)
    kwargs = {f.name: _build(hints[f.name], d[f.name])
              for f in dataclasses.fields(cls) if f.name in d}
    return cls(**kwargs)
