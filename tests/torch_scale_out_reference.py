"""The JAX package's DistributedOdometry on chip_smoke.py's scale-out frames,
on the CPU: the mean APE of a 1-device mesh that chip_smoke.py's scale-out
phase bounds the port's run by, for each insert mode; with ``--meshes``,
how far the end poses of the first ``--gap-frames`` frames move between a
1-device mesh and larger ones (the same program, its moment sums added in
another order: how much rounding alone moves this scene's registration,
which bounds chip_smoke.py's comparisons of runs that sum differently).

    PYTHONPATH=. python tests/torch_scale_out_reference.py [--frames 80]
    PYTHONPATH=. python tests/torch_scale_out_reference.py --modes "" \
        --meshes 2,4 --gap-frames 10

The frames are the 80-frame driving corridor, seed 3
(``ct_icp_torch/datasets/corridor.py``, numpy only), through
``default_driving_profile()``. Prints one JSON line. Not collected by pytest.
"""

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# meshes of up to 8 virtual CPU devices (--meshes)
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from ct_icp_torch.datasets import corridor as cor  # noqa: E402
from ct_icp_tpu.config.options import default_driving_profile  # noqa: E402
from ct_icp_tpu.parallel.distributed_odometry import \
    DistributedOdometry  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--seed", type=int, default=cor.APE_SEEDS[0])
    ap.add_argument("--modes", default="broadcast,partitioned")
    ap.add_argument("--meshes", default="")
    ap.add_argument("--gap-frames", type=int, default=10)
    a = ap.parse_args()
    scene = cor.build_scene()
    traj = cor.straight_trajectory(400, a.frames * 0.1 + 0.5)
    frames = cor.render_corridor(scene, traj, a.frames, a.seed)
    first_gt = frames[0]["begin_pose"]
    mesh = Mesh(np.array(jax.devices()[:1]), ("map",))
    out = {"frames": a.frames, "seed": a.seed}
    for mode in [m for m in a.modes.split(",") if m]:
        t0 = time.time()
        odo = DistributedOdometry(mesh, default_driving_profile(),
                                  map_update=mode)
        for fr in frames:
            odo.register_frame(fr["xyz"], fr["timestamps"])
        errs = [float(np.linalg.norm(
            est.end_pose.tr - (first_gt.inverse() * fr["end_pose"]).tr))
            for est, fr in zip(odo.trajectory, frames)]
        out[mode] = {"mean_ape_m": float(np.mean(errs)),
                     "final_drift_m": errs[-1], "map_points": odo.map_size(),
                     "dropped": odo.dropped_points,
                     "first3_end_tr": [f.end_pose.tr.tolist()
                                       for f in odo.trajectory[:3]],
                     "wall_s": time.time() - t0}
        print(json.dumps({mode: out[mode]}), flush=True)
    if a.meshes:
        out["gaps_to_mesh_1"] = mesh_gaps(
            frames[:a.gap_frames], [int(m) for m in a.meshes.split(",")])
    print(json.dumps(out), flush=True)


def mesh_gaps(frames, sizes):
    """{size: per-frame (translation m, rotation deg) gaps of the end poses
    to a 1-device mesh}, broadcast insert."""
    def ends(n):
        mesh = Mesh(np.array(jax.devices()[:n]), ("map",))
        odo = DistributedOdometry(mesh, default_driving_profile())
        for fr in frames:
            odo.register_frame(fr["xyz"], fr["timestamps"])
        return [f.end_pose for f in odo.trajectory]
    one = ends(1)
    out = {}
    for n in sizes:
        other = ends(n)
        out[n] = [[float(a.location_distance(b)),
                   float(a.angular_distance(b))]
                  for a, b in zip(one, other)]
        print(json.dumps({f"mesh {n} vs 1": out[n]}), flush=True)
    return out


if __name__ == "__main__":
    main()
