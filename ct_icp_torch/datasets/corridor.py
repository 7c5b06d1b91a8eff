"""The synthetic urban driving corridor of the reference's driving, robust
and escalation gates.

Copies of ``bench.py``'s ``build_scene``, ``straight_trajectory``,
``render_corridor``, ``seq_ape`` (bench.py:309-376) and
``_jolt_trajectory`` (bench.py:580-618), and of its gate constants, so the
port and chip_smoke.py can drive the same workloads without the JAX
package. The robust gate drives ``robust_corridor_trajectory`` (8 m/s,
below the robust profile's 1 m per-scan translation threshold); the
escalation gate a yaw jolt and a speed surge on the same corridor.
"""

import numpy as np

from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.pose import Pose
from ct_icp_torch.core.trajectory import LinearContinuousTrajectory
from ct_icp_torch.datasets import synthetic as syn

# The driving gate: mean APE over three scan-realization seeds <= 0.07 m
# with 0 failures over the 80-frame corridor (bench.py:58-59).
APE_BOUND_M = 0.07
APE_SEEDS = (3, 4, 5)

# The robust gate: 3-seed mean APE <= 0.058 m over the 80-frame corridor at
# 8 m/s through robust_driving_profile (bench.py:101-102).
ROBUST_BASELINE_SEC_PER_FRAME = 0.26
ROBUST_APE_BOUND_M = 0.058

# The escalation gate (bench.py:298-306): a yaw jolt over frames [18, 24)
# and a speed surge to 14 m/s over frames [40, 48), robust_num_attempts=3.
ESC_BURST = (18, 24)          # [first, last) jolt frame indices
ESC_YAW_AMP_DEG = 45.0        # look-around ramp over the jolt window
ESC_SURGE = (40, 48)          # [first, last) speed-surge frame indices
ESC_SURGE_SPEED = 14.0        # m/s inside the surge (cruise 8)
ESC_POST_APE_BOUND_M = 0.15
ESC_MIN_BURST_ATTEMPTS = 1.1  # mean attempts over the jolt window
ESC_MIN_BURST_LEVEL = 0.7     # mean robust_level over the jolt window
ESC_MIN_GAP_LEVEL = 2         # the deep-ladder assertion
ESC_MIN_EXHAUSTED_FRAMES = 2  # frames that must climb the full ladder


def build_scene():
    """A 250 m urban corridor: ground + two building walls with openings,
    facade relief every ~8 m, parked obstacles."""
    prims = []
    for x0 in range(-20, 250, 40):
        prims += syn.rectangle([x0, -12, 0], [36, 0, 0], [0, 0, 8])
        prims += syn.rectangle([x0 + 2, 10, 0], [36, 0, 0], [0, 0, 8])
    prims += syn.rectangle([-20, -13, 0], [290, 0, 0], [0, 26, 0])  # ground
    # cross-track surfaces make the along-corridor direction observable
    for x0 in range(-16, 248, 8):
        prims += syn.rectangle([x0, -12, 0], [0, 1.5, 0], [0, 0, 4])
        prims += syn.rectangle([x0 + 4, 10, 0], [0, -1.5, 0], [0, 0, 4])
    rng = np.random.default_rng(0)
    for _ in range(30):
        c = np.array([rng.uniform(0, 230), rng.uniform(-8, 8), 1.0])
        prims.append(syn.Ball(c, 0.8))
    return syn.Scene(prims)


def straight_trajectory(num_poses, total_time, speed=10.0, accel=2.5):
    """Accelerate from rest to ``speed``, with a slow yaw and lateral sway."""
    t_ramp = speed / accel
    poses = []
    for i in range(num_poses):
        t = i / (num_poses - 1) * total_time
        if t < t_ramp:
            x = 0.5 * accel * t * t
        else:
            x = 0.5 * accel * t_ramp ** 2 + speed * (t - t_ramp)
        yaw = 0.08 * np.sin(0.5 * t)
        q = s3n.quat_from_rotvec(np.array([0.0, 0.0, yaw]))
        poses.append(Pose(q, np.array([x, 0.3 * np.sin(0.2 * t), 1.7]),
                          timestamp=t))
    return LinearContinuousTrajectory(poses)


def render_corridor(scene, traj, num_frames, seed, max_range=50.0):
    acq = syn.SyntheticSensorAcquisition(
        scene, traj,
        syn.SyntheticAcquisitionOptions(
            num_points_per_frame=100_000, frame_duration=0.1,
            max_range=max_range, min_range=2.0, noise_sigma=0.01),
        seed=seed)
    return [acq.frame(i) for i in range(min(num_frames, acq.num_frames()))]


def seq_ape(odo, frames):
    """Per-frame end-pose translation errors vs GT (estimate starts at GT
    frame 0: conjugate GT into the estimate frame)."""
    first_gt = frames[0]["begin_pose"]
    return [np.linalg.norm(est.end_pose.tr
                           - (first_gt.inverse() * fr["end_pose"]).tr)
            for est, fr in zip(odo.get_trajectory(), frames)]


def robust_corridor_trajectory(num_frames: int):
    """The robust gate's drive (bench.py:515): the corridor at 8 m/s."""
    return straight_trajectory(400, num_frames * 0.1 + 0.5, speed=8.0)


def jolt_trajectory(num_poses, total_time, burst_t0, burst_t1, speed=8.0,
                    accel=2.5, amp_deg=ESC_YAW_AMP_DEG, surge_t0=None,
                    surge_t1=None, surge_speed=14.0):
    """straight_trajectory + a constant-rate yaw ramp of ``amp_deg`` inside
    [burst_t0, burst_t1] + an optional speed surge to ``surge_speed`` inside
    [surge_t0, surge_t1]."""
    amp = np.deg2rad(amp_deg)
    ts = np.linspace(0.0, total_time, num_poses)
    v = np.minimum(accel * ts, speed)        # standstill ramp
    if surge_t0 is not None:
        ramp = 0.2                            # s to reach surge speed
        up = np.clip((ts - surge_t0) / ramp, 0.0, 1.0)
        down = np.clip((surge_t1 - ts) / ramp, 0.0, 1.0)
        boost = (surge_speed - speed) * np.minimum(up, down)
        # only inside the window: keep the standstill ramp elsewhere
        v = np.where(boost > 0.0, np.maximum(v, speed + boost), v)
    x = np.concatenate([[0.0], np.cumsum(0.5 * (v[1:] + v[:-1])
                                         * np.diff(ts))])
    poses = []
    for i in range(num_poses):
        t = ts[i]
        yaw = 0.08 * np.sin(0.5 * t)
        frac = np.clip((t - burst_t0) / (burst_t1 - burst_t0), 0.0, 1.0)
        yaw += amp * frac
        q = s3n.quat_from_rotvec(np.array([0.0, 0.0, yaw]))
        poses.append(Pose(q, np.array([x[i], 0.3 * np.sin(0.2 * t), 1.7]),
                          timestamp=t))
    return LinearContinuousTrajectory(poses)


def escalation_trajectory(num_frames: int):
    """The escalation gate's drive (bench.py:630-644): the jolt, and the
    surge when the horizon reaches it."""
    b0, b1 = ESC_BURST
    s0, s1 = ESC_SURGE
    surge = num_frames >= s1
    return jolt_trajectory(
        400, num_frames * 0.1 + 0.5, burst_t0=b0 * 0.1, burst_t1=b1 * 0.1,
        amp_deg=ESC_YAW_AMP_DEG,
        surge_t0=s0 * 0.1 if surge else None,
        surge_t1=s1 * 0.1 if surge else None,
        surge_speed=ESC_SURGE_SPEED)
