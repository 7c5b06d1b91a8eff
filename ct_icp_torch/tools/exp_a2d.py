"""How far K2's a2D and its plain version's part on exact planes and on
noisy ones, at the distance strategy's radii, on the card.

    python3 -m ct_icp_torch.tools.exp_a2d [--seeds 8]

For each seed: a 0.8 m level (2^14 rows of 30 points) holding a street's
ground (2 cm of noise) and two walls (exact planes, or with 1 cm of noise
on every coordinate), 700 queries on the same surfaces, each with a radius
drawn from 0.1-2.0 m, K1 over 343 voxels kept to 48; K2 and its plain
version, fresh and with the shell radius cached at the queries moved by 1
cm, with and without the k-nearest cap. Prints one JSON line a seed and
noise: the largest a2D gap where a query has >= 5 points (the tolerance
of ``kernels/checks.py`` is 1e-3), whether the moments were identical,
and the card's line. Seed 32 draws the inputs of
``tests/test_torch_kernels_gpu.py::
test_plane_moments_radius_per_query_matches_plain`` (with noise 0, the
exact planes it held before its walls took noise). On an exact plane the
smallest eigenvalue of a large neighbourhood is float32 rounding and a2D
takes its square root.
"""

import argparse
import json
import subprocess

import numpy as np
import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import plane_moments as k2
from ct_icp_torch.mapping import voxel_map as vm


def scene(rng, n):
    """Ground (2 cm of noise) and two walls at y = +-10 m."""
    g = np.stack([rng.uniform(-20, 20, n), rng.uniform(-10, 10, n),
                  rng.normal(scale=0.02, size=n)], -1)
    w = np.stack([rng.uniform(-20, 20, n),
                  np.where(rng.uniform(size=n) < .5, -10.0, 10.0),
                  rng.uniform(0, 6, n)], -1)
    return np.concatenate([g, w]).astype(np.float32)


def gaps(seed, noise, dev):
    rng = np.random.default_rng(seed)
    level = vm.make_level(14, 30, dev)
    pts = scene(rng, 20000)
    if noise:       # as tests/test_torch_kernels_gpu.py::_warm_level
        pts = pts + rng.normal(scale=noise, size=pts.shape).astype(
            np.float32)
    pts = torch.from_numpy(pts).to(dev)
    vm.insert_points(level, pts, torch.ones(pts.shape[0], dtype=torch.bool,
                                            device=dev), 0.8, 0.1, 12)
    q = torch.from_numpy(scene(rng, 700)).to(dev)
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    radius = torch.from_numpy(rng.uniform(0.1, 2.0, q.shape[0]).astype(
        np.float32)).to(dev)
    slots, cnt = vm.gather_candidate_planes(level, q, valid, 0.8, 3,
                                            max_candidates=48)
    worst, same = 0.0, True
    for k_nearest in (40, None):
        fresh = k2.plane_moments_plain(level.points, slots, cnt, q, radius,
                                       k_nearest)
        for qq, cached in ((q, None), (q + 0.01, fresh.r_eff2)):
            got = k2.plane_moments(level.points, slots, cnt, qq, radius,
                                   k_nearest, cached)
            want = k2.plane_moments_plain(level.points, slots, cnt, qq,
                                          radius, k_nearest, cached)
            full = want.count >= 5
            worst = max(worst,
                        (got.a2d[full] - want.a2d[full]).abs().max().item())
            same = same and bool(torch.equal(got.sum_outer, want.sum_outer))
    return worst, same


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_a2d: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    build.prepare()
    for noise in (0.0, 0.01):
        for seed in range(32, 32 + args.seeds):
            worst, same = gaps(seed, noise, dev)
            print(json.dumps({"noise_m": noise, "seed": seed,
                              "max_a2d_gap": worst,
                              "moments_identical": same}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
