"""The JAX package's staged per-frame path on chip_smoke.py's staged runs,
on the CPU: the mean APE and the failures that chip_smoke.py's staged
phases hold the port's runs to (within 1.5 times the APE, with 0
failures), for each of:

  adaptive         default_driving_profile() with sampling=ADAPTIVE;
  adaptive_robust  the same with robust_registration=True;
  cap              default_driving_profile() with max_num_keypoints=1000
                   (GRID keypoints, the random cap from frame
                   init_num_frames on);
  none             default_driving_profile() with sampling=NONE;
  adaptive_k2_cap  ADAPTIVE with num_points_per_voxel=2 and
                   max_num_points=3000.

    PYTHONPATH=. python tests/torch_staged_reference.py \\
        [--runs adaptive,cap] [--frames 80]

Every run registers the driving corridor's frames (seed 3,
``ct_icp_torch/datasets/corridor.py``, numpy only) one at a time through
``Odometry.register_frame``: ``--frames`` (default 80) are rendered, as
chip_smoke.py's driving phase renders them, and a run takes all of them or,
given as ``name:n``, the first n (chip_smoke.py runs none and
adaptive_k2_cap for 10 frames). Prints one JSON line a run. Not collected
by pytest.
"""

import argparse
import dataclasses
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from ct_icp_torch.datasets import corridor as cor  # noqa: E402
from ct_icp_tpu.config import options as jopt  # noqa: E402
from ct_icp_tpu.odometry.odometry import Odometry  # noqa: E402


def run_options(name: str):
    """The options of chip_smoke.py's staged run ``name``, in the JAX
    package."""
    d = jopt.default_driving_profile()
    adaptive = jopt.SamplingOption.ADAPTIVE
    if name == "adaptive":
        return dataclasses.replace(d, sampling=adaptive)
    if name == "adaptive_robust":
        return dataclasses.replace(d, sampling=adaptive,
                                   robust_registration=True)
    if name == "cap":
        return dataclasses.replace(d, max_num_keypoints=1000)
    if name == "none":
        return dataclasses.replace(d, sampling=jopt.SamplingOption.NONE)
    if name == "adaptive_k2_cap":
        return dataclasses.replace(
            d, sampling=adaptive,
            adaptive_options=jopt.AdaptiveGridSamplingOptions(
                num_points_per_voxel=2, max_num_points=3000))
    raise ValueError(name)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--seed", type=int, default=cor.APE_SEEDS[0])
    ap.add_argument("--runs", default="adaptive,adaptive_robust,cap,"
                                      "none:10,adaptive_k2_cap:10")
    a = ap.parse_args()
    runs = []
    for r in (r for r in a.runs.split(",") if r):
        name, _, n = r.partition(":")
        runs.append((name, int(n) if n else a.frames))
    # the corridor of chip_smoke.py's driving phase: ``--frames`` frames
    # rendered, each run on the first of them
    scene = cor.build_scene()
    traj = cor.straight_trajectory(400, a.frames * 0.1 + 0.5)
    frames = cor.render_corridor(scene, traj, a.frames, a.seed)
    for name, n in runs:
        t0 = time.time()
        odo = Odometry(run_options(name))
        summaries = [odo.register_frame(f["xyz"], f["timestamps"],
                                        frame_id=i)
                     for i, f in enumerate(frames[:n])]
        errs = cor.seq_ape(odo, frames[:n])
        print(json.dumps({name: {
            "frames": n, "seed": a.seed,
            "mean_ape_m": float(np.mean(errs)),
            "max_ape_m": float(np.max(errs)),
            "failures": sum(not s.success for s in summaries),
            "mean_keypoints": float(np.mean(
                [s.sample_size for s in summaries[1:]])),
            "mean_attempts": float(np.mean(
                [s.number_of_attempts for s in summaries])),
            "seconds": time.time() - t0}}), flush=True)


if __name__ == "__main__":
    main()
