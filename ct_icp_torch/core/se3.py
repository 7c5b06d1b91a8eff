"""Device-side (torch, float32) instance of the SE3/quaternion math.

``core/math_impl.py::build`` is written against numpy's function names; the
shim below maps them onto torch so one set of formulas serves both the
host (numpy float64, ``se3_np``) and the device (torch float32, here). Every
function it uses is differentiable by ``torch.func.jacfwd``.
"""

from types import SimpleNamespace

import torch

from ct_icp_torch.core.math_impl import build


def _maximum(a, b):
    if not torch.is_tensor(b):
        return torch.clamp_min(a, b)
    if not torch.is_tensor(a):
        return torch.clamp_min(b, a)
    return torch.maximum(a, b)


def _cross(a, b):
    # written out: the solver differentiates through quat_rotate with
    # torch.func.jacfwd, and with torch.linalg.cross there (torch 2.13, CPU)
    # its poses leave the reference's by 3.5 cm on test_torch_solver's
    # problem; the written-out form agrees within 1e-4 m
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _minimum(a, b):
    if not torch.is_tensor(b):
        return torch.clamp_max(a, b)
    if not torch.is_tensor(a):
        return torch.clamp_max(b, a)
    return torch.minimum(a, b)


_xp = SimpleNamespace(
    sqrt=torch.sqrt,
    sin=torch.sin,
    cos=torch.cos,
    abs=torch.abs,
    arccos=torch.arccos,
    arctan2=torch.atan2,
    clip=torch.clamp,
    where=torch.where,
    zeros_like=torch.zeros_like,
    ones_like=torch.ones_like,
    asarray=torch.as_tensor,
    maximum=_maximum,
    minimum=_minimum,
    sum=lambda x, axis=None, keepdims=False: torch.sum(
        x, dim=axis, keepdim=keepdims),
    stack=lambda xs, axis=0: torch.stack(xs, dim=axis),
    concatenate=lambda xs, axis=0: torch.cat(xs, dim=axis),
    cross=_cross,
    argmax=lambda x, axis=None: torch.argmax(x, dim=axis),
    arange=torch.arange,
    broadcast_to=lambda x, shape: torch.as_tensor(x).expand(shape),
)

_m = build(_xp)

quat_normalize = _m.quat_normalize
quat_mul = _m.quat_mul
quat_conj = _m.quat_conj
quat_rotate = _m.quat_rotate
quat_to_matrix = _m.quat_to_matrix
quat_from_rotvec = _m.quat_from_rotvec
quat_slerp = _m.quat_slerp
angular_distance_deg = _m.angular_distance_deg
se3_apply = _m.se3_apply
se3_compose = _m.se3_compose
se3_inverse = _m.se3_inverse
se3_interpolate = _m.se3_interpolate
alpha_timestamp = _m.alpha_timestamp


def quat_from_matrix(m):
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w first),
    by core/math_impl.py's branchless Shepperd's method; its constant
    tensors are made on ``m``'s device."""
    with torch.device(m.device):
        return _m.quat_from_matrix(m)


def se3_matrix(q, t):
    """(quaternion [..., 4], translation [..., 3]) -> [..., 4, 4]; the
    bottom row is made on ``t``'s device."""
    with torch.device(t.device):
        return _m.se3_matrix(q, t)


# array helpers of the same namespace, for code written against either this
# module or core/dual.py's ``math`` (the residuals take one or the other)
sum = _xp.sum
concatenate = _xp.concatenate
stack = _xp.stack
sqrt = _xp.sqrt
cross = _xp.cross
where = _xp.where
