"""Synthetic scenes: geometric primitives + a GT trajectory -> simulated scans.

Host copy of the part of ``ct_icp_tpu/datasets/synthetic.py`` that the
driving corridor (datasets/corridor.py) uses: triangle and ball primitives
sampled into point clouds, a Scene aggregating them, and a
SyntheticSensorAcquisition producing per-frame point clouds with exact
per-point interpolated-pose timestamps (reference
include/SlamCore/experimental/synthetic.h). Same seeds, same frames.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.trajectory import LinearContinuousTrajectory


class Primitive:
    def sample(self, n: int, rng) -> np.ndarray:
        raise NotImplementedError

    def area_weight(self) -> float:
        return 1.0

    def bound(self):
        """(center [3], radius) bounding sphere — used by windowed
        acquisition to skip primitives out of sensor range."""
        pts = self.sample(8, np.random.default_rng(0))
        c = pts.mean(axis=0)
        return c, float(np.linalg.norm(pts - c, axis=-1).max())


@dataclasses.dataclass
class Triangle(Primitive):
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray

    def sample(self, n, rng):
        u = rng.uniform(0, 1, (n, 1))
        v = rng.uniform(0, 1, (n, 1))
        flip = (u + v) > 1.0
        u = np.where(flip, 1.0 - u, u)
        v = np.where(flip, 1.0 - v, v)
        return (np.asarray(self.a) + u * (np.asarray(self.b) - np.asarray(self.a))
                + v * (np.asarray(self.c) - np.asarray(self.a)))

    def area_weight(self):
        ab = np.asarray(self.b) - np.asarray(self.a)
        ac = np.asarray(self.c) - np.asarray(self.a)
        return 0.5 * float(np.linalg.norm(np.cross(ab, ac)))

    def bound(self):
        v = np.stack([np.asarray(self.a, np.float64),
                      np.asarray(self.b, np.float64),
                      np.asarray(self.c, np.float64)])
        c = v.mean(axis=0)
        return c, float(np.linalg.norm(v - c, axis=-1).max())


@dataclasses.dataclass
class Ball(Primitive):
    center: np.ndarray
    radius: float

    def sample(self, n, rng):
        v = rng.normal(size=(n, 3))
        v /= np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        r = self.radius * rng.uniform(0, 1, (n, 1)) ** (1.0 / 3.0)
        return np.asarray(self.center) + r * v

    def area_weight(self):
        return 4.0 * np.pi * self.radius ** 2

    def bound(self):
        return np.asarray(self.center, np.float64), float(self.radius)


def rectangle(corner, edge_u, edge_v) -> List[Triangle]:
    """Axis-aligned wall helper: two triangles spanning corner+u, corner+v."""
    a = np.asarray(corner, dtype=np.float64)
    b = a + np.asarray(edge_u, dtype=np.float64)
    c = a + np.asarray(edge_v, dtype=np.float64)
    d = b + np.asarray(edge_v, dtype=np.float64)
    return [Triangle(a, b, c), Triangle(d, c, b)]


class Scene:
    """Aggregate of primitives; samples proportionally to primitive area."""

    def __init__(self, primitives: Sequence[Primitive]):
        self.primitives = list(primitives)
        w = np.array([p.area_weight() for p in self.primitives], dtype=np.float64)
        self.weights = w / max(w.sum(), 1e-12)

    def sample(self, n: int, rng) -> np.ndarray:
        counts = rng.multinomial(n, self.weights)
        parts = [p.sample(int(c), rng)
                 for p, c in zip(self.primitives, counts) if c > 0]
        pts = np.concatenate(parts, axis=0) if parts else np.zeros((0, 3))
        return pts[rng.permutation(pts.shape[0])]

    def _bounds(self):
        if not hasattr(self, "_bound_cache"):
            cs, rs = [], []
            for p in self.primitives:
                c, r = p.bound()
                cs.append(c)
                rs.append(r)
            self._bound_cache = (np.stack(cs), np.asarray(rs))
        return self._bound_cache

    def subset_near(self, center, radius) -> "Scene":
        """Sub-scene of primitives whose bounding sphere intersects the
        query sphere — large drive-scale scenes sample at full local density
        instead of diluting points over the whole map (the global sampler is
        uniform by area)."""
        cs, rs = self._bounds()
        d = np.linalg.norm(cs - np.asarray(center, np.float64), axis=-1)
        keep = d - rs <= radius
        if keep.all():
            return self
        prims = [p for p, k in zip(self.primitives, keep) if k]
        return Scene(prims if prims else self.primitives)

    def sample_lidar(self, n: int, rng, sensor, d_floor: float = 6.0
                     ) -> np.ndarray:
        """Range-weighted sampling: per-primitive weight area/d^2 (d =
        bound-center distance to ``sensor``, floored at ``d_floor``).

        A real scanning LiDAR distributes rays uniformly in ANGLE, so
        surface density falls off as 1/d^2 — the uniform-by-area sampler
        would give a distant facade the same points/m^2 as the road under
        the vehicle, leaving near-field neighborhoods too sparse for ICP's
        min_number_neighbors on open drive-scale scenes."""
        cs, rs = self._bounds()
        d = np.maximum(np.linalg.norm(
            cs - np.asarray(sensor, np.float64), axis=-1), d_floor)
        w = np.array([p.area_weight() for p in self.primitives]) / (d * d)
        w = w / max(w.sum(), 1e-12)
        counts = rng.multinomial(n, w)
        parts = [p.sample(int(c), rng)
                 for p, c in zip(self.primitives, counts) if c > 0]
        pts = np.concatenate(parts, axis=0) if parts else np.zeros((0, 3))
        return pts[rng.permutation(pts.shape[0])]


@dataclasses.dataclass
class SyntheticAcquisitionOptions:
    num_points_per_frame: int = 20000
    frame_duration: float = 0.1
    max_range: float = 100.0
    min_range: float = 0.5
    noise_sigma: float = 0.0     # isotropic point noise (meters)
    # sample only primitives within max_range of the frame pose (plus the
    # sweep motion): local density stays constant on drive-scale scenes
    windowed: bool = False


class SyntheticSensorAcquisition:
    """Scene + GT trajectory -> per-frame (raw points, timestamps, gt poses).

    Replicates the reference SyntheticSensorAcquisition semantics
    (synthetic.h:205-228): points are sampled on the scene, stamped with a
    timestamp linear across the sweep, and expressed in the sensor frame of
    the pose interpolated at that timestamp.
    """

    def __init__(self, scene: Scene, trajectory: LinearContinuousTrajectory,
                 options: SyntheticAcquisitionOptions = SyntheticAcquisitionOptions(),
                 seed: int = 0):
        self.scene = scene
        self.trajectory = trajectory
        self.options = options
        self.seed = seed
        # kept for compatibility; frame() derives a per-index rng instead —
        # a shared sequential stream makes frame(i) depend on CALL ORDER,
        # which silently changes the data under multi-threaded prefetch
        # rendering (measured: the 500-frame gate drifted 0.35 -> 1.08 %Tr
        # run to run purely from worker scheduling)
        self.rng = np.random.default_rng(seed)

    def num_frames(self) -> int:
        span = self.trajectory.timestamps[-1] - self.trajectory.timestamps[0]
        return max(int(np.floor(span / self.options.frame_duration)), 0)

    def frame(self, index: int):
        """Returns dict(xyz [N,3] sensor frame, timestamps [N], begin_pose,
        end_pose) for frame ``index``."""
        o = self.options
        rng = np.random.default_rng((self.seed, index))
        t0 = self.trajectory.timestamps[0] + index * o.frame_duration
        t1 = t0 + o.frame_duration
        n = o.num_points_per_frame
        scene = self.scene
        if o.windowed:
            # windowed mode doubles as the LiDAR-like local density model:
            # primitives outside range are dropped AND the remainder is
            # range-weighted (area/d^2), approximating a scanner's uniform-
            # in-angle ray distribution
            begin = self.trajectory.interpolate_pose(t0)
            scene = self.scene.subset_near(begin.tr, o.max_range + 20.0)
            world = scene.sample_lidar(2 * n, rng, begin.tr)
        else:
            world = scene.sample(2 * n, rng)
        ts = rng.uniform(t0, t1, world.shape[0])
        ts.sort()
        q, tr = self.trajectory.interpolate_poses(ts)
        qi, ti = s3n.se3_inverse(q, tr)
        raw = s3n.quat_rotate(qi, world) + ti
        rng_d = np.linalg.norm(raw, axis=-1)
        keep = (rng_d >= o.min_range) & (rng_d <= o.max_range)
        raw, ts = raw[keep][:n], ts[keep][:n]
        if o.noise_sigma > 0:
            raw = raw + rng.normal(scale=o.noise_sigma, size=raw.shape)
        begin = self.trajectory.interpolate_pose(t0)
        end = self.trajectory.interpolate_pose(t1)
        begin.timestamp, end.timestamp = t0, t1
        return {"xyz": raw, "timestamps": ts,
                "begin_pose": begin, "end_pose": end}
