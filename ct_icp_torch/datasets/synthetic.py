"""Synthetic scenes: geometric primitives + a GT trajectory -> simulated scans.

Host copy of ``ct_icp_tpu/datasets/synthetic.py`` without the uniform pose
noise: triangle, line, sphere and ball primitives sampled into point
clouds, the room, indoor and city-block scenes, a Scene aggregating them,
a SyntheticSensorAcquisition producing per-frame point clouds with exact
per-point interpolated-pose timestamps (reference
include/SlamCore/experimental/synthetic.h), and the circular and waypoint
drive trajectories. The driving corridor (datasets/corridor.py) and the
YAML scenes (config/yaml_config.py) build on it. Same seeds, same frames.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.pose import Pose
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
class Line(Primitive):
    a: np.ndarray
    b: np.ndarray

    def sample(self, n, rng):
        t = rng.uniform(0, 1, (n, 1))
        return np.asarray(self.a) + t * (np.asarray(self.b) - np.asarray(self.a))

    def area_weight(self):
        return float(np.linalg.norm(np.asarray(self.b) - np.asarray(self.a)))

    def bound(self):
        a, b = np.asarray(self.a, np.float64), np.asarray(self.b, np.float64)
        c = 0.5 * (a + b)
        return c, float(np.linalg.norm(b - c))


@dataclasses.dataclass
class Sphere(Primitive):
    center: np.ndarray
    radius: float

    def sample(self, n, rng):
        v = rng.normal(size=(n, 3))
        v /= np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        return np.asarray(self.center) + self.radius * v

    def area_weight(self):
        return 4.0 * np.pi * self.radius ** 2

    def bound(self):
        return np.asarray(self.center, np.float64), float(self.radius)


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


def box_room(half_extent=10.0, height=4.0) -> List[Triangle]:
    """A closed rectangular room: floor, ceiling, four walls."""
    h = half_extent
    tris: List[Triangle] = []
    tris += rectangle([-h, -h, 0], [2 * h, 0, 0], [0, 2 * h, 0])          # floor
    tris += rectangle([-h, -h, height], [2 * h, 0, 0], [0, 2 * h, 0])     # ceiling
    tris += rectangle([-h, -h, 0], [2 * h, 0, 0], [0, 0, height])         # wall y-
    tris += rectangle([-h, h, 0], [2 * h, 0, 0], [0, 0, height])          # wall y+
    tris += rectangle([-h, -h, 0], [0, 2 * h, 0], [0, 0, height])         # wall x-
    tris += rectangle([h, -h, 0], [0, 2 * h, 0], [0, 0, height])          # wall x+
    return tris


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


def apply_uniform_noise(poses: Sequence[Pose], rng, tr_scale: float,
                        rot_scale_deg: float) -> List[Pose]:
    """Uniform pose-noise injection (reference ApplyUniformNoise,
    synthetic.h:233-242): ``rng`` (a numpy Generator) draws, for each pose,
    a translation in [-tr_scale, tr_scale]^3, then a rotation axis and an
    angle in [0, rot_scale_deg], in that order."""
    out = []
    for p in poses:
        dtr = rng.uniform(-tr_scale, tr_scale, 3)
        rv = rng.uniform(-1, 1, 3)
        rv = rv / max(np.linalg.norm(rv), 1e-12) * np.deg2rad(
            rng.uniform(0, rot_scale_deg))
        q = s3n.quat_mul(s3n.quat_from_rotvec(rv), p.quat)
        out.append(Pose(s3n.quat_normalize(q), p.tr + dtr, p.timestamp,
                        p.frame_id))
    return out


def circular_trajectory(radius=8.0, height=1.5, num_poses=200,
                        total_time=10.0, angle_span=2 * np.pi
                        ) -> LinearContinuousTrajectory:
    """A smooth circular GT trajectory for tests/benchmarks."""
    poses = []
    for i in range(num_poses):
        s = i / (num_poses - 1)
        ang = s * angle_span
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        yaw = ang + np.pi / 2
        q = s3n.quat_from_rotvec(np.array([0.0, 0.0, yaw]))
        poses.append(Pose(q, pos, timestamp=s * total_time))
    return LinearContinuousTrajectory(poses)


def waypoint_drive_trajectory(waypoints, speed_profile=None, height=1.7,
                              pose_rate=20.0, corner_radius=4.0,
                              max_accel=2.5, sway_deg=0.0,
                              sway_period_s=1.2, bob_amp=0.0,
                              max_yaw_rate_dps=0.0):
    """A driving trajectory along a 2-D waypoint polyline.

    The long-horizon analog of ``circular_trajectory`` for KITTI-style
    regression sequences (reference regression_config_short_drive.yaml
    grades 500-frame drives): corners are rounded to ``corner_radius``,
    yaw follows the path tangent, and speed follows ``speed_profile`` — a
    list of ``(arclength_m, speed_mps)`` control points interpolated
    linearly in distance (so slow-traffic sections and stops are expressed
    as profile dips). Acceleration from standstill is capped by
    ``max_accel`` (odometry's constant-velocity capture range needs the
    ramp, like real drives that begin at rest).

    ``sway_deg``/``sway_period_s``/``bob_amp``: handheld-carry motion —
    sinusoidal roll+pitch of that amplitude and a vertical bob, the
    low-inertia regime (NCLT segway / handheld) where the begin/end
    attitude changes within every scan.

    ``max_yaw_rate_dps`` > 0: slow down at high-curvature sections so the
    heading rate never exceeds this bound (v <= max_yaw_rate / curvature),
    like a real carrier that cannot snap-turn. Without it, tight waypoint
    corners at constant speed inject heading rates of 100-250 deg/s —
    physically absurd for a walking/segway platform (NCLT peaks ~30 deg/s)
    and the root cause of the round-4 indoor gate's chaotic doorway-turn
    transients (0.87-2.50 %Tr seed spread from borderline-trackable snap
    turns; tools/exp_indoor_transient.py measured 10-25 deg/FRAME at the
    diamonds' vertices).
    """
    wp = np.asarray(waypoints, np.float64)
    if wp.shape[1] == 2:
        wp = np.concatenate([wp, np.zeros((wp.shape[0], 1))], axis=1)
    # densify the polyline at 5 cm steps: the corner-rounding boxcar below
    # can only bound curvature at the grid it runs on — a 0.25 m grid left
    # near-kinks between samples (fine-grid curvature 4x the coarse
    # estimate, measured 11.8 vs 2.7 rad/m at the indoor diamonds), which
    # the pose resampler then traced through as 100-250 deg/s yaw snaps
    step = 0.05
    pts = [wp[0]]
    for a, b in zip(wp[:-1], wp[1:]):
        seg = b - a
        length = np.linalg.norm(seg)
        k = max(int(np.ceil(length / step)), 1)
        for i in range(1, k + 1):
            pts.append(a + seg * (i / k))
    path = np.stack(pts)
    # round corners: moving average over ~corner_radius of arclength
    w = max(int(corner_radius / step), 1)
    if w > 1:
        kern = np.ones(w) / w
        pad = np.concatenate([np.repeat(path[:1], w, axis=0), path,
                              np.repeat(path[-1:], w, axis=0)])
        sm = np.stack([np.convolve(pad[:, i], kern, mode="same")
                       for i in range(3)], axis=1)
        path = sm[w:-w]
    seg_len = np.linalg.norm(np.diff(path, axis=0), axis=-1)
    s = np.concatenate([[0.0], np.cumsum(seg_len)])
    total_len = s[-1]

    if speed_profile is None:
        speed_profile = [(0.0, 10.0)]
    sp = np.asarray(speed_profile, np.float64)

    # curvature-limited speed cap (see docstring): kappa from the smoothed
    # path tangent, then v_cap(s) = max_yaw_rate / kappa
    if max_yaw_rate_dps > 0.0:
        d1 = np.gradient(path[:, :2], s, axis=0, edge_order=1)
        yaw_path = np.unwrap(np.arctan2(d1[:, 1], d1[:, 0]))
        kappa = np.abs(np.gradient(yaw_path, s, edge_order=1))  # rad/m
        v_curv = np.deg2rad(max_yaw_rate_dps) / np.maximum(kappa, 1e-6)
    else:
        v_curv = None

    def v_of_s(ss):
        v = np.interp(ss, sp[:, 0], sp[:, 1])
        ramp = np.sqrt(np.maximum(2.0 * max_accel * np.maximum(ss, 0.01),
                                  0.09))
        v = np.minimum(v, ramp)
        if v_curv is not None:
            v = np.minimum(v, np.interp(ss, s, v_curv))
        return np.clip(v, 0.15 if v_curv is not None else 0.3, None)

    # integrate time along the arclength
    mid_v = v_of_s(0.5 * (s[:-1] + s[1:]))
    dt = seg_len / mid_v
    t = np.concatenate([[0.0], np.cumsum(dt)])
    total_time = t[-1]

    # poses at uniform pose_rate
    n_poses = max(int(total_time * pose_rate), 2)
    ts = np.linspace(0.0, total_time, n_poses)
    ss = np.interp(ts, t, s)
    xyz = np.stack([np.interp(ss, s, path[:, i]) for i in range(3)], axis=1)
    xyz[:, 2] += height
    # yaw from the smoothed tangent
    tang = np.gradient(xyz[:, :2], ss, axis=0, edge_order=1)
    yaw = np.unwrap(np.arctan2(tang[:, 1], tang[:, 0]))
    sway = np.deg2rad(sway_deg)
    poses = []
    for i in range(n_poses):
        q = s3n.quat_from_rotvec(np.array([0.0, 0.0, yaw[i]]))
        if sway > 0.0:
            w = 2.0 * np.pi * ts[i] / sway_period_s
            roll = sway * np.sin(w)
            pitch = 0.6 * sway * np.sin(0.77 * w + 1.0)
            q = s3n.quat_mul(q, s3n.quat_mul(
                s3n.quat_from_rotvec(np.array([0.0, pitch, 0.0])),
                s3n.quat_from_rotvec(np.array([roll, 0.0, 0.0]))))
        p = xyz[i].copy()
        if bob_amp > 0.0:
            p[2] += bob_amp * np.sin(2.0 * np.pi * ts[i] / (0.5 * sway_period_s))
        poses.append(Pose(q, p, timestamp=float(ts[i])))
    return LinearContinuousTrajectory(poses)


def _wall_with_door(corner, along, height=2.6, door_at=None, door_w=0.9,
                    door_h=2.0):
    """A vertical wall from ``corner`` along the 2-D vector ``along``,
    optionally with a doorway cut at arclength ``door_at``."""
    corner = np.asarray(corner, np.float64)
    along = np.asarray(along, np.float64)
    length = np.linalg.norm(along)
    u = along / length
    prims = []
    if door_at is None or door_at < 0 or door_at + door_w > length:
        prims += rectangle(corner, along, [0, 0, height])
        return prims
    left = u * door_at
    if door_at > 1e-6:
        prims += rectangle(corner, left, [0, 0, height])
    right0 = corner + u * (door_at + door_w)
    rlen = length - door_at - door_w
    if rlen > 1e-6:
        prims += rectangle(right0, u * rlen, [0, 0, height])
    # lintel above the door
    prims += rectangle(corner + left + [0, 0, door_h], u * door_w,
                       [0, 0, height - door_h])
    return prims


def indoor_rooms(n_rooms=4, room=(6.0, 5.0), corridor_w=2.0, height=2.6,
                 n_clutter=10, seed=0):
    """A handheld-scale indoor scene: ``n_rooms`` rooms (2 per side) off a
    central corridor, connected by 0.9 m doorways, with floor, ceiling and
    furniture-like clutter. The NCLT-regime analog fixture: tight spaces,
    surfaces at 1-6 m, doorway transitions that occlude whole walls.

    The corridor runs along +x at y in [0, corridor_w]; rooms attach at
    y < 0 and y > corridor_w. Doorways face the corridor.
    """
    rw, rd = room
    per_side = (n_rooms + 1) // 2
    length = per_side * rw
    prims: List[Primitive] = []
    rng = np.random.default_rng(seed)
    # floor + ceiling tiles over the full footprint
    tile = 3.0
    for tx in np.arange(0.0, length, tile):
        for ty in np.arange(-rd, corridor_w + rd, tile):
            sx = min(tile, length - tx)
            sy = min(tile, corridor_w + rd - ty)
            prims += rectangle([tx, ty, 0.0], [sx, 0, 0], [0, sy, 0])
            prims += rectangle([tx, ty, height], [sx, 0, 0], [0, sy, 0])
    # corridor end walls
    prims += _wall_with_door([0, -rd, 0], [0, corridor_w + 2 * rd, 0],
                             height)
    prims += _wall_with_door([length, -rd, 0], [0, corridor_w + 2 * rd, 0],
                             height)
    for k in range(n_rooms):
        side = 1 if k % 2 else -1          # +1: y > corridor, -1: y < 0
        i = k // 2
        x0 = i * rw
        y_wall = corridor_w if side > 0 else 0.0
        # doorway centered on the room: routes defined in a YAML can pass
        # through it without knowing the clutter seed
        door_at = rw * 0.5 - 0.45
        # corridor-facing wall with a doorway
        prims += _wall_with_door([x0, y_wall, 0], [rw, 0, 0], height,
                                 door_at=door_at)
        # back wall + side walls of the room
        y_back = y_wall + side * rd
        prims += _wall_with_door([x0, y_back, 0], [rw, 0, 0], height)
        prims += _wall_with_door([x0, min(y_wall, y_back), 0],
                                 [0, rd, 0], height)
        prims += _wall_with_door([x0 + rw, min(y_wall, y_back), 0],
                                 [0, rd, 0], height)
        # furniture-like clutter: boxes (as 2-3 faces) and balls
        for _ in range(n_clutter // 2):
            cx = x0 + rng.uniform(0.8, rw - 0.8)
            cy = (y_wall + side * rng.uniform(0.8, rd - 0.8))
            if rng.uniform() < 0.5:
                h = rng.uniform(0.4, 1.2)
                w = rng.uniform(0.4, 1.5)
                prims += rectangle([cx, cy, h], [w, 0, 0], [0, w, 0])
                prims += rectangle([cx, cy, 0], [w, 0, 0], [0, 0, h])
                prims += rectangle([cx, cy, 0], [0, w, 0], [0, 0, h])
            else:
                prims.append(Ball(np.array([cx, cy, 0.35]),
                                  rng.uniform(0.2, 0.4)))
    return prims


def city_blocks(nx=5, ny=3, block=40.0, street=14.0, height=8.0,
                relief_every=8.0, n_obstacles=60, seed=0):
    """A drive-scale urban scene: a grid of building blocks separated by
    streets, with ground, facade relief (pillars/doorways that make the
    along-street direction observable) and parked obstacles.

    Streets run along the grid lines; block (i, j) occupies
    [i*(block+street), ...] + [street, street]. The route YAML picks
    waypoints down street centerlines.
    """
    pitch = block + street
    prims: List[Primitive] = []
    x1 = nx * pitch + street
    y1 = ny * pitch + street
    # ground spanning everything (+ margin), TILED so the windowed sampler
    # can drop far-away patches (one giant rectangle would dominate the
    # area weights everywhere and dilute the local sample density)
    tile = 20.0
    gx = np.arange(-20.0, x1 + 40.0, tile)
    gy = np.arange(-20.0, y1 + 40.0, tile)
    for tx in gx:
        for ty in gy:
            prims += rectangle([tx, ty, 0.0], [tile, 0.0, 0.0],
                               [0.0, tile, 0.0])
    rng = np.random.default_rng(seed)
    for i in range(nx):
        for j in range(ny):
            x0 = street + i * pitch
            y0 = street + j * pitch
            h = height * rng.uniform(0.7, 1.4)
            # four facade walls
            prims += rectangle([x0, y0, 0], [block, 0, 0], [0, 0, h])
            prims += rectangle([x0, y0 + block, 0], [block, 0, 0], [0, 0, h])
            prims += rectangle([x0, y0, 0], [0, block, 0], [0, 0, h])
            prims += rectangle([x0 + block, y0, 0], [0, block, 0], [0, 0, h])
            # relief: pillars jutting into the street every relief_every m
            k = 0.0
            while k + 2.0 < block:
                prims += rectangle([x0 + k, y0, 0], [0, -1.2, 0], [0, 0, 4])
                prims += rectangle([x0 + k, y0 + block, 0], [0, 1.2, 0],
                                   [0, 0, 4])
                prims += rectangle([x0, y0 + k, 0], [-1.2, 0, 0], [0, 0, 4])
                prims += rectangle([x0 + block, y0 + k, 0], [1.2, 0, 0],
                                   [0, 0, 4])
                k += relief_every
    # parked obstacles along the streets
    for _ in range(n_obstacles):
        gi = rng.integers(0, nx + 1)
        along = rng.uniform(0, y1)
        lane = rng.uniform(2.0, street - 2.0)
        if rng.uniform() < 0.5:
            c = np.array([gi * pitch + lane, along, 0.8])
        else:
            c = np.array([along, gi * pitch + lane, 0.8])
        if 0 <= c[0] <= x1 and 0 <= c[1] <= y1:
            prims.append(Ball(c, rng.uniform(0.5, 1.0)))
    return prims
