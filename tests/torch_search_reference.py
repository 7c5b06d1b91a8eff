"""The JAX package's Odometry on chip_smoke.py's search runs, on the CPU:
the mean APE and the failures that chip_smoke.py's knn, distance and
device sub-sample phases hold the port's runs to (within 1.5 times the
APE, with 0 failures), for each of:

  knn        default_driving_profile() with ball_neighborhood=False (the
             exact k-NN search; tools/ab_accuracy.py's streaming_knn);
  knn_kc2    the same with num_closest_neighbors=2, on the first
             ``--kc2-frames`` frames;
  distance   default_driving_profile() with the reference's
             DistanceBasedStrategyOptions() (the per-point radius and the
             normal filter);
  devsub     default_driving_profile() with host_subsample=False (the
             device sub-sample of the raw scan).

    PYTHONPATH=. python tests/torch_search_reference.py [--runs knn,devsub]

The frames are the 80-frame driving corridor, seed 3
(``ct_icp_torch/datasets/corridor.py``, numpy only), streamed at batch 16:
its first ``--first`` (40, as chip_smoke.py's search runs take them) for
knn, distance and devsub, its first ``--kc2-frames`` for knn_kc2. Prints
one JSON line a run. Not collected by pytest.
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

BATCH = 16


def run_options(name: str):
    """The options of chip_smoke.py's run ``name``, in the JAX package."""
    d = jopt.default_driving_profile()
    icp = d.ct_icp_options
    if name == "knn":
        return dataclasses.replace(d, ct_icp_options=dataclasses.replace(
            icp, ball_neighborhood=False))
    if name == "knn_kc2":
        return dataclasses.replace(d, ct_icp_options=dataclasses.replace(
            icp, ball_neighborhood=False, num_closest_neighbors=2))
    if name == "distance":
        return dataclasses.replace(
            d, distance_strategy=jopt.DistanceBasedStrategyOptions())
    if name == "devsub":
        return dataclasses.replace(d, host_subsample=False)
    raise ValueError(name)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--kc2-frames", type=int, default=10)
    ap.add_argument("--first", type=int, default=40)
    ap.add_argument("--seed", type=int, default=cor.APE_SEEDS[0])
    ap.add_argument("--runs", default="knn,knn_kc2,distance,devsub")
    a = ap.parse_args()
    scene = cor.build_scene()
    traj = cor.straight_trajectory(400, a.frames * 0.1 + 0.5)
    frames = cor.render_corridor(scene, traj, a.frames, a.seed)
    for name in [r for r in a.runs.split(",") if r]:
        n = a.kc2_frames if name == "knn_kc2" else min(a.first, a.frames)
        t0 = time.time()
        odo = Odometry(run_options(name))
        preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i,
                                   upload=False)
                 for i, f in enumerate(frames[:n])]
        summaries = list(odo.stream_frames(iter(preps), batch=BATCH))
        errs = cor.seq_ape(odo, frames[:n])
        print(json.dumps({name: {
            "frames": n, "seed": a.seed, "batch": BATCH,
            "mean_ape_m": float(np.mean(errs)),
            "final_drift_m": float(errs[-1]),
            "failures": sum(not s.success for s in summaries),
            "map_points": odo.map_size(),
            "residuals_per_frame": float(np.mean(
                [s.number_of_residuals for s in summaries])),
            "wall_s": time.time() - t0}}), flush=True)


if __name__ == "__main__":
    main()
