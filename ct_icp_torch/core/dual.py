"""Forward-mode derivatives in plain torch: dual numbers with a batch of
tangents.

A ``Dual`` carries a value ``v`` and ``T`` tangents ``t`` (shape
``[T, *v.shape]``). ``math`` is ``core/math_impl.py`` built over duals, so
the quaternion / SE3 formulas of the port run unchanged and yield their
Jacobian with respect to T input directions in one pass — what
``torch.func.jacfwd`` computes, written out: the LM step's plain version
uses it because ``jacfwd`` runs its elementwise rules through Python
decompositions on the CPU (~40 ms a step at K = 2048, against a few ms
here). The derivative rules are those of the kernel K5 (csrc/lm_step.cu).
"""

from types import SimpleNamespace

import torch

from ct_icp_torch.core.math_impl import build


def _align(t, shape):
    """Tangents ``t`` [T, *s] broadcast to [T, *shape]."""
    s = tuple(t.shape[1:])
    shape = tuple(shape)
    if s == shape:
        return t
    t = t.reshape((t.shape[0],) + (1,) * (len(shape) - len(s)) + s)
    return t.expand((t.shape[0],) + shape)


class Dual:
    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v, self.t = v, t

    @staticmethod
    def seed(v):
        """``v`` [T] as the T input directions (identity tangents)."""
        return Dual(v, torch.eye(v.shape[0], dtype=v.dtype, device=v.device))

    @property
    def ndim(self):
        return self.v.ndim

    @property
    def shape(self):
        return self.v.shape

    def jacobian(self):
        """d value / d inputs as [*v.shape, T]."""
        return torch.movedim(self.t, 0, -1)

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return Dual(self.v[idx], self.t[(slice(None),) + idx])

    def reshape(self, *shape):
        return Dual(self.v.reshape(*shape),
                    self.t.reshape((self.t.shape[0],) + self.v.reshape(
                        *shape).shape))

    def expand(self, *shape):
        return Dual(self.v.expand(*shape), _align(self.t, shape))

    def __neg__(self):
        return Dual(-self.v, -self.t)

    def __add__(self, o):
        if isinstance(o, Dual):
            v = self.v + o.v
            return Dual(v, _align(self.t, v.shape) + _align(o.t, v.shape))
        v = self.v + o
        return Dual(v, _align(self.t, v.shape))

    __radd__ = __add__

    def __sub__(self, o):
        return self + (-o)

    def __rsub__(self, o):
        return (-self) + o

    def __mul__(self, o):
        if isinstance(o, Dual):
            v = self.v * o.v
            return Dual(v, _align(self.t, v.shape) * o.v
                        + self.v * _align(o.t, v.shape))
        v = self.v * o
        return Dual(v, _align(self.t, v.shape) * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Dual):
            v = self.v / o.v
            return Dual(v, (_align(self.t, v.shape)
                            - v * _align(o.t, v.shape)) / o.v)
        v = self.v / o
        return Dual(v, _align(self.t, v.shape) / o)

    def __rtruediv__(self, o):
        v = o / self.v
        return Dual(v, -(v / self.v) * _align(self.t, v.shape))

    def __lt__(self, o):
        return self.v < (o.v if isinstance(o, Dual) else o)

    def __gt__(self, o):
        return self.v > (o.v if isinstance(o, Dual) else o)


def _val(x):
    return x.v if isinstance(x, Dual) else x


def _lift(x, like: Dual):
    if isinstance(x, Dual):
        return x
    x = torch.as_tensor(x, dtype=like.v.dtype, device=like.v.device)
    return Dual(x, torch.zeros((like.t.shape[0],) + tuple(x.shape),
                               dtype=x.dtype, device=x.device))


def _first_dual(xs):
    return next(x for x in xs if isinstance(x, Dual))


def _where(cond, a, b):
    if not isinstance(a, Dual) and not isinstance(b, Dual):
        return torch.where(cond, a, b)
    like = a if isinstance(a, Dual) else b
    a, b = _lift(a, like), _lift(b, like)
    v = torch.where(cond, a.v, b.v)
    return Dual(v, torch.where(cond, _align(a.t, v.shape),
                               _align(b.t, v.shape)))


def _maximum(a, lo):
    """clamp_min: the tangent passes where the value is kept."""
    v = torch.clamp_min(a.v, lo)
    return Dual(v, torch.where(a.v >= lo, a.t, torch.zeros_like(a.t)))


def _clip(a, lo, hi):
    keep = (a.v >= lo) & (a.v <= hi)
    return Dual(torch.clamp(a.v, lo, hi),
                torch.where(keep, a.t, torch.zeros_like(a.t)))


def _unary(fn, dfn):
    def op(a):
        if not isinstance(a, Dual):
            return fn(a)
        return Dual(fn(a.v), dfn(a.v) * a.t)
    return op


def _sqrt(a):
    v = torch.sqrt(a.v)
    return Dual(v, a.t / (2.0 * v))


def _sum(x, axis=None, keepdims=False):
    if not isinstance(x, Dual):
        return torch.sum(x, dim=axis, keepdim=keepdims)
    if axis is None:
        return Dual(torch.sum(x.v), x.t.reshape(x.t.shape[0], -1).sum(1))
    t_axis = axis if axis < 0 else axis + 1
    return Dual(torch.sum(x.v, dim=axis, keepdim=keepdims),
                torch.sum(x.t, dim=t_axis, keepdim=keepdims))


def _join(fn, xs, axis):
    if not any(isinstance(x, Dual) for x in xs):
        return fn(xs, dim=axis)
    like = _first_dual(xs)
    xs = [_lift(x, like) for x in xs]
    t_axis = axis if axis < 0 else axis + 1
    return Dual(fn([x.v for x in xs], dim=axis),
                fn([x.t for x in xs], dim=t_axis))


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return _join(torch.stack, [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                               a0 * b1 - a1 * b0], -1)


_xp = SimpleNamespace(
    sqrt=_sqrt,
    sin=_unary(torch.sin, torch.cos),
    cos=_unary(torch.cos, lambda x: -torch.sin(x)),
    arccos=_unary(torch.arccos, lambda x: -1.0 / torch.sqrt(1.0 - x * x)),
    abs=_unary(torch.abs, torch.sign),
    clip=_clip,
    where=_where,
    maximum=_maximum,
    zeros_like=lambda x: torch.zeros_like(_val(x)),
    ones_like=lambda x: torch.ones_like(_val(x)),
    asarray=lambda x: x if isinstance(x, Dual) else torch.as_tensor(x),
    sum=_sum,
    stack=lambda xs, axis=0: _join(torch.stack, xs, axis),
    concatenate=lambda xs, axis=0: _join(torch.cat, xs, axis),
    cross=_cross,
)

math = build(_xp)
math.sum = _sum
math.concatenate = _xp.concatenate
math.stack = _xp.stack
math.sqrt = _sqrt
math.cross = _cross
math.where = _where
where = _where
