"""K1 ``candidate_gather`` and K2 ``plane_moments`` of two source trees on
the same inputs, on the card.

    python -m ct_icp_torch.tools.exp_header_trees <other tree>

Builds ``csrc/candidate_gather.cu`` and ``csrc/plane_moments.cu`` of this
tree and of ``<other tree>`` (a checkout holding a ``ct_icp_torch``
package, e.g. ``git archive`` of another commit), each in its own process
and ``build/`` directory, runs both kernels of each on the same inputs (a
level of 2^16 slots x 40 points filled by K3 from a seeded street scene; K1
over all 27 voxels and kept to 10 of 125; K2 fresh with a k-NN cap, with a
cached radius and without the cap) and compares a SHA-256 of every output
bit for bit, and the kernels' SASS instructions (``cuobjdump -sass``, the
instruction lines only). Prints one JSON line (the digests of this tree as
``digest``, which ``chip_smoke.py`` holds its build to); exits 1 when
anything differs. It shows that moving device code into shared headers
(K1's probe into ``csrc/probe.cuh``, K2's eigensolve into
``csrc/eigh3.cuh``) changed neither kernel.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

# Runs in a child process with the tree to test first on sys.path; uses
# only the wrappers' signatures that every tree since K1 and K2 returned
# slots has.
CHILD = r'''
import hashlib, json, subprocess, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import candidate_gather as k1
from ct_icp_torch.kernels import plane_moments as k2
from ct_icp_torch.mapping import voxel_map as vm
assert build.__file__.startswith(sys.argv[1]), build.__file__


def digest():
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    n = 60000
    g = np.stack([rng.uniform(-20, 20, n), rng.uniform(-10, 10, n),
                  rng.normal(scale=0.02, size=n)], -1)
    w = np.stack([rng.uniform(-20, 20, n),
                  np.where(rng.uniform(size=n) < .5, -10.0, 10.0),
                  rng.uniform(0, 6, n)], -1)
    pts = torch.from_numpy(np.concatenate([g, w]).astype(np.float32)).to(dev)
    level = vm.make_level(16, 40, dev)
    vm.insert_points(level, pts, torch.ones(pts.shape[0], dtype=torch.bool,
                                            device=dev), 0.5, 0.1, 12)
    q = pts[torch.from_numpy(rng.choice(pts.shape[0], 3000,
                                        replace=False)).to(dev)]
    q = q + torch.from_numpy(rng.normal(scale=0.05, size=(3000, 3)).astype(
        np.float32)).to(dev)
    qv = torch.from_numpy(rng.uniform(size=3000) < 0.95).to(dev)
    out = {}
    for name, (nv, max_c) in (("k1 27", (1, 0)), ("k1 10 of 125", (2, 10))):
        slots, cnt = k1.candidate_gather(level.keys, level.count, q, qv, 0.5,
                                         nv, 1, max_c)
        out[name] = [slots, cnt]
    slots, cnt = out["k1 27"]
    fresh = k2.plane_moments(level.points, slots, cnt, q, 0.75, 20)
    cached = k2.plane_moments(level.points, slots, cnt, q, 0.75, 20,
                              fresh.r_eff2)
    full = k2.plane_moments(level.points, slots, cnt, q, 0.75, None)
    out["k2 fresh"], out["k2 cached"], out["k2 full"] = fresh, cached, full
    torch.cuda.synchronize()
    # the outputs a call made (a normal-only K2 call leaves the rest of the
    # descriptor None)
    return {k: hashlib.sha256(b"".join(
                t.contiguous().cpu().numpy().tobytes() for t in v
                if t is not None)).hexdigest() for k, v in out.items()}


res = {"digest": digest()}
for name in ("candidate_gather", "plane_moments"):
    sass = subprocess.run(["cuobjdump", "-sass", str(build._lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    ins = [line.strip() for line in sass.splitlines() if "/*0" in line]
    res[name + " sass"] = hashlib.sha256("\n".join(ins).encode()).hexdigest()
    res[name + " sass_instructions"] = len(ins)
print(json.dumps(res))
'''


def run_tree(root: Path) -> dict:
    env = dict(os.environ)
    cuda_bin = os.path.join(env.get("CUDA_HOME", "/usr/local/cuda"), "bin")
    env["PATH"] = cuda_bin + os.pathsep + env.get("PATH", "")
    out = subprocess.run([sys.executable, "-c", CHILD, str(root)],
                         capture_output=True, text=True, env=env, cwd=root)
    if out.returncode:
        raise RuntimeError(f"{root}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__.splitlines()[3].strip(), file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[2]
    other = Path(args[0]).resolve()
    a, b = run_tree(here), run_tree(other)
    same = {key: a[key] == b[key] for key in a}
    print(json.dumps({"this": str(here), "other": str(other),
                      "identical": same, "digest": a["digest"]}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
