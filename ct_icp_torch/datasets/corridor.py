"""The synthetic urban driving corridor of the reference's driving gate.

Copies of ``bench.py``'s ``build_scene``, ``straight_trajectory``,
``render_corridor`` and ``seq_ape`` (bench.py:309-376) and of its accuracy
gate constants, so the port and chip_smoke.py can drive the same workload
without the JAX package.
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
