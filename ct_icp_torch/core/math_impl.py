"""Quaternion / SE3 math, written once and instantiated for two array backends.

The same formulas serve two worlds:
  * the device world (``jax.numpy``, float32, traced under ``jit``/``vmap``),
  * the host world (``numpy``, float64, the odometry driver + datasets + eval).

All functions are shape-polymorphic over leading batch dimensions: a quaternion
is ``[..., 4]`` with the scalar part FIRST (w, x, y, z), a translation is
``[..., 3]``.

Semantics follow the reference CT-ICP implementation (see SURVEY.md):
  * SE3 compose / inverse / apply           — reference include/SlamCore/types.h:343-365
  * Interpolate = slerp(quat) + lerp(tr)    — reference include/SlamCore/types.h:361-366
  * GetAlphaTimestamp clamping              — reference include/SlamCore/types.h:192-219
    (below-min and above-max BOTH clamp to 0, equal-endpoints returns 1 —
    replicated exactly, including the surprising above-max case)
  * AngularDistance in degrees via rotation-matrix trace
                                            — reference include/SlamCore/types.h:141-150
"""

from types import SimpleNamespace


def build(xp):
    """Build the math namespace over array module `xp` (numpy or jax.numpy)."""

    def quat_normalize(q):
        n = xp.sqrt(xp.sum(q * q, axis=-1, keepdims=True))
        return q / xp.maximum(n, 1e-30)

    def quat_mul(p, q):
        pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
        qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        return xp.stack(
            [
                pw * qw - px * qx - py * qy - pz * qz,
                pw * qx + px * qw + py * qz - pz * qy,
                pw * qy - px * qz + py * qw + pz * qx,
                pw * qz + px * qy - py * qx + pz * qw,
            ],
            axis=-1,
        )

    def quat_conj(q):
        return xp.stack([q[..., 0], -q[..., 1], -q[..., 2], -q[..., 3]], axis=-1)

    def quat_rotate(q, v):
        """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
        qv = q[..., 1:4]
        w = q[..., 0:1]
        t = 2.0 * xp.cross(qv, v)
        return v + w * t + xp.cross(qv, t)

    def quat_to_matrix(q):
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        wx, wy, wz = w * x, w * y, w * z
        m = xp.stack(
            [
                1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
            ],
            axis=-1,
        )
        return m.reshape(m.shape[:-1] + (3, 3))

    def quat_from_matrix(m):
        """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w first).

        Branchless Shepperd's method: compute all four candidate solutions and
        select the best-conditioned one (largest pivot), so it is safe under
        vmap/jit and for any input rotation.
        """
        m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
        m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
        m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
        tr = m00 + m11 + m22

        def _safe_sqrt(v):
            return xp.sqrt(xp.maximum(v, 1e-30))

        # candidate 0: pivot on w
        s0 = _safe_sqrt(1.0 + tr) * 2.0
        q0 = xp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], axis=-1)
        # candidate 1: pivot on x
        s1 = _safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
        q1 = xp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], axis=-1)
        # candidate 2: pivot on y
        s2 = _safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
        q2 = xp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], axis=-1)
        # candidate 3: pivot on z
        s3 = _safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
        q3 = xp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], axis=-1)

        pivots = xp.stack([tr, m00, m11, m22], axis=-1)
        best = xp.argmax(pivots, axis=-1)
        cands = xp.stack([q0, q1, q2, q3], axis=-2)  # [..., 4cand, 4]
        onehot = (
            xp.arange(4).reshape((1,) * (len(m.shape) - 2) + (4, 1)) == best[..., None, None]
        )
        q = xp.sum(xp.where(onehot, cands, xp.zeros_like(cands)), axis=-2)
        return quat_normalize(q)

    def quat_from_rotvec(rv):
        """Exponential map: axis-angle vector [..., 3] -> quaternion [..., 4]."""
        theta2 = xp.sum(rv * rv, axis=-1, keepdims=True)
        theta = xp.sqrt(xp.maximum(theta2, 1e-30))
        half = 0.5 * theta
        small = theta2 < 1e-12
        # sin(x/2)/x -> 0.5 - x^2/48 for small x
        k = xp.where(small, 0.5 - theta2 / 48.0, xp.sin(half) / theta)
        w = xp.where(small[..., 0], 1.0 - theta2[..., 0] / 8.0, xp.cos(half[..., 0]))
        return xp.concatenate([w[..., None], k * rv], axis=-1)

    def quat_slerp(q0, q1, t):
        """Spherical interpolation with shortest-path sign handling.

        `t` broadcasts against the batch shape of q0/q1. NaN-safe denominators
        keep forward- and reverse-mode differentiation well-defined near
        parallel quaternions (falls back to nlerp there).
        """
        t = xp.asarray(t)
        if t.ndim == q0.ndim - 1:
            t = t[..., None]  # broadcast over the quaternion component axis
        d = xp.sum(q0 * q1, axis=-1, keepdims=True)
        q1 = xp.where(d < 0.0, -q1, q1)
        d = xp.abs(d)
        d = xp.clip(d, -1.0, 1.0)
        near = d > 1.0 - 1e-7
        theta = xp.arccos(xp.where(near, xp.zeros_like(d), d))
        sin_theta = xp.sin(theta)
        sin_safe = xp.where(near, xp.ones_like(sin_theta), sin_theta)
        w0 = xp.where(near, 1.0 - t, xp.sin((1.0 - t) * theta) / sin_safe)
        w1 = xp.where(near, t, xp.sin(t * theta) / sin_safe)
        return quat_normalize(w0 * q0 + w1 * q1)

    def angular_distance_deg(qa, qb):
        """Angle (degrees) between two rotations (reference AngularDistance,
        types.h:141-150)."""
        rel = quat_mul(quat_conj(quat_normalize(qa)), quat_normalize(qb))
        # same quantity as acos((trace-1)/2) = acos(2w^2-1), but the atan2 form
        # stays accurate for tiny angles in float32 (acos saturates ~0.04 deg),
        # which matters for the ICP convergence thresholds (1e-4 deg).
        s = xp.sqrt(xp.sum(rel[..., 1:4] ** 2, axis=-1))
        c = xp.abs(rel[..., 0])
        return 2.0 * xp.arctan2(s, c) * (180.0 / 3.14159265358979323846)

    # ------------------------------------------------------------------ SE3 —
    # an SE3 is the pair (quat [...,4], tr [...,3]); kept as separate arrays
    # so the pytree flattening under jit is trivial.

    def se3_apply(quat, tr, points):
        return quat_rotate(quat_normalize(quat), points) + tr

    def se3_compose(qa, ta, qb, tb):
        """(qa,ta) * (qb,tb) — apply b first, then a."""
        q = quat_normalize(quat_mul(qa, qb))
        t = quat_rotate(quat_normalize(qa), tb) + ta
        return q, t

    def se3_inverse(q, t):
        qi = quat_conj(quat_normalize(q))
        return qi, -quat_rotate(qi, t)

    def se3_interpolate(q0, t0, q1, t1, alpha):
        """slerp on rotation + lerp on translation (reference types.h:361-366)."""
        a = xp.asarray(alpha)
        if a.ndim == q0.ndim - 1:
            a = a[..., None]
        q = quat_slerp(q0, q1, a)
        t = (1.0 - a) * t0 + a * t1
        return q, t

    def alpha_timestamp(ts, t_begin, t_end):
        """Reference GetAlphaTimestamp semantics (types.h:192-219).

        Below min -> 0, above max -> 0 (sic — the reference returns 0 there too,
        despite its log message), equal endpoints -> 1, else linear in [0, 1].
        """
        tmin = xp.minimum(t_begin, t_end)
        tmax = xp.maximum(t_begin, t_end)
        denom = tmax - tmin
        degenerate = denom <= 0.0
        safe_denom = xp.where(degenerate, xp.ones_like(denom), denom)
        alpha = (ts - tmin) / safe_denom
        alpha = xp.where(degenerate, xp.ones_like(alpha), alpha)
        alpha = xp.where(ts < tmin, xp.zeros_like(alpha), alpha)
        alpha = xp.where(ts > tmax, xp.zeros_like(alpha), alpha)
        return alpha

    def se3_matrix(q, t):
        m = quat_to_matrix(quat_normalize(q))
        bottom_shape = m.shape[:-2] + (1, 4)
        top = xp.concatenate([m, t[..., :, None]], axis=-1)
        bottom = xp.broadcast_to(xp.asarray([0.0, 0.0, 0.0, 1.0]), bottom_shape)
        return xp.concatenate([top, bottom], axis=-2)

    return SimpleNamespace(
        quat_normalize=quat_normalize,
        quat_mul=quat_mul,
        quat_conj=quat_conj,
        quat_rotate=quat_rotate,
        quat_to_matrix=quat_to_matrix,
        quat_from_matrix=quat_from_matrix,
        quat_from_rotvec=quat_from_rotvec,
        quat_slerp=quat_slerp,
        angular_distance_deg=angular_distance_deg,
        se3_apply=se3_apply,
        se3_compose=se3_compose,
        se3_inverse=se3_inverse,
        se3_interpolate=se3_interpolate,
        se3_matrix=se3_matrix,
        alpha_timestamp=alpha_timestamp,
    )
