"""The JAX package on chip_smoke.py's solver runs, on the CPU: the mean APE
and the failures that chip_smoke.py's solver phase holds the port's runs to
(within 1.5 times the APE, with 0 failures), for each of
default_driving_profile() with:

  gn                 solver=GN, max_dist_to_plane_ct_icp=0.5;
  robust_solver      solver=ROBUST (the reference defaults: use_lines,
                     use_distribution);
  distribution       distance=POINT_TO_DISTRIBUTION;
  huber              loss_function=HUBER;
  analytic           analytic_jacobian=True;
  constant_velocity  motion_compensation=CONSTANT_VELOCITY;
  profiled           profile_registration=True.

    PYTHONPATH=. python tests/torch_solver_reference.py [--runs gn,huber]

Every run registers the driving corridor's frames (seed 3, 80 rendered as
chip_smoke.py's driving phase renders them,
``ct_icp_torch/datasets/corridor.py``) one at a time through
``Odometry.register_frame``, the first 20 (profiled: 10; ``name:n`` sets
another count). Prints one JSON line a run (with each frame's APE). Not
collected by pytest.
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

RUNS = {"gn": 20, "robust_solver": 20, "distribution": 20, "huber": 20,
        "analytic": 20, "constant_velocity": 20, "profiled": 10}


def run_options(name: str, o=jopt):
    """The options of chip_smoke.py's solver run ``name`` in the options
    module ``o`` (the JAX package's or the port's)."""
    d = o.default_driving_profile()
    icp = d.ct_icp_options
    kw = {"gn": dict(solver=o.Solver.GN, max_dist_to_plane_ct_icp=0.5),
          "robust_solver": dict(solver=o.Solver.ROBUST),
          "distribution": dict(
              distance=o.IcpDistance.POINT_TO_DISTRIBUTION),
          "huber": dict(loss_function=o.LeastSquares.HUBER),
          "analytic": dict(analytic_jacobian=True)}.get(name)
    if kw is not None:
        return dataclasses.replace(
            d, ct_icp_options=dataclasses.replace(icp, **kw))
    if name == "constant_velocity":
        return dataclasses.replace(
            d, motion_compensation=o.MotionCompensation.CONSTANT_VELOCITY)
    if name == "profiled":
        return dataclasses.replace(d, profile_registration=True)
    raise ValueError(name)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default=",".join(RUNS))
    a = ap.parse_args()
    scene = cor.build_scene()
    traj = cor.straight_trajectory(400, 80 * 0.1 + 0.5)
    frames = cor.render_corridor(scene, traj, 80, cor.APE_SEEDS[0])
    for r in (r for r in a.runs.split(",") if r):
        name, _, n = r.partition(":")
        n = int(n) if n else RUNS[name]
        t0 = time.time()
        odo = Odometry(run_options(name))
        summaries = [odo.register_frame(f["xyz"], f["timestamps"],
                                        frame_id=i)
                     for i, f in enumerate(frames[:n])]
        errs = cor.seq_ape(odo, frames[:n])
        print(json.dumps({name: dict(
            frames=n, failures=sum(not s.success for s in summaries),
            mean_ape_m=float(np.mean(errs)),
            ape_by_frame_m=[float(e) for e in errs],
            seconds=time.time() - t0)}), flush=True)


if __name__ == "__main__":
    main()
