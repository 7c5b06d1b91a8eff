"""K5 ``lm_loop`` of two source trees on the same inputs, on the card.

    python -m ct_icp_torch.tools.exp_k5_trees <other tree>

Builds ``csrc/lm_step.cu`` of this tree and of ``<other tree>`` (a checkout
holding a ``ct_icp_torch`` package, e.g. ``git archive`` of another commit),
each in its own process and its own ``build/`` directory, runs ``lm_loop``
of each on the same inputs (four LM calls: K = 900 to 70,000 rows, 1 to 20
steps, drawn from one numpy generator) and compares the final states bit
for bit, and the kernels' SASS instructions (``cuobjdump -sass``, the
instruction lines only: the entry's mangled name carries a per-file hash).
Prints one JSON line; exits 1 when a final state differs (the SASS may
differ: it is reported, not held). It shows that a change to K5's source
that should not change the point-to-plane Cauchy call's results (moving
device code into a shared header; more instances beside it; one library
a family) did not.
Each call is also timed, a CUDA graph of its one launch
(``tools/timing.py::time_graph``, the tree's own), the trees in the order
other, this, this, other.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

_CHILD = r'''
import hashlib, json, subprocess, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from ct_icp_torch.config.options import LeastSquares
from ct_icp_torch.kernels import build, lm_step as k5
from ct_icp_torch.tools.timing import time_graph
assert build.__file__.startswith(sys.argv[1]), build.__file__
dev = torch.device("cuda")
rng = np.random.default_rng(7)
out = {}
for k, steps in ((2941, 20), (2941, 1), (900, 3), (70000, 5)):
    raw = rng.uniform(-20, 20, (k, 3))
    al = rng.uniform(0, 1, k)
    n = rng.normal(size=(k, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    anc = raw + np.array([0.3, -0.2, 0.05]) + rng.normal(scale=0.05,
                                                         size=(k, 3))
    w = rng.uniform(0.2, 1, k)
    ok = rng.uniform(size=k) < 0.9
    rows = torch.from_numpy(np.concatenate(
        [raw, al[:, None], anc, n, w[:, None], ok[:, None]],
        1).astype(np.float32)).to(dev)
    prior = torch.tensor([1, 0, 0, 0, 0.1, 0, 0, 0.5, 0, 0, 1e-3, 1e-3, 1e-3,
                          1e-3], dtype=torch.float32, device=dev)
    n_res = torch.tensor(int(ok.sum()), dtype=torch.int32, device=dev)
    qb = torch.tensor([0.999, 0.01, -0.02, 0.03], device=dev)
    qe = torch.tensor([0.998, 0.02, -0.01, 0.05], device=dev)
    state = k5.init_state(qb / qb.norm(), torch.tensor([0.1, 0.2, 0.0],
                                                      device=dev),
                          qe / qe.norm(), torch.tensor([0.6, 0.1, 0.02],
                                                      device=dev))
    state0 = state.clone()
    k5.lm_loop(rows, prior, n_res, state, steps, LeastSquares.CAUCHY, 0.5,
               0.0, False)
    torch.cuda.synchronize()
    out[f"K={k} steps={steps}"] = state.cpu().numpy().tobytes().hex()
    st = state0.clone()
    ms, _ = time_graph(lambda: st.copy_(state0), lambda: k5.lm_loop(
        rows, prior, n_res, st, steps, LeastSquares.CAUCHY, 0.5, 0.0, False))
    out[f"ms K={k} steps={steps}"] = ms
# every library of the source (a tree that builds one a family has several)
libs = ([build._lib_path(*lib) for lib in build.libraries("lm_step")]
        if hasattr(build, "libraries") else [build._lib_path("lm_step")])
ins = [line.strip() for lib in libs for line in subprocess.run(
    ["cuobjdump", "-sass", str(lib)], capture_output=True, text=True,
    check=True).stdout.splitlines() if "/*0" in line]
out["sass"] = hashlib.sha256("\n".join(ins).encode()).hexdigest()
out["sass_instructions"] = len(ins)
print(json.dumps(out))
'''


def _run(root: Path) -> dict:
    env = dict(os.environ)
    cuda_bin = os.path.join(env.get("CUDA_HOME", "/usr/local/cuda"), "bin")
    env["PATH"] = cuda_bin + os.pathsep + env.get("PATH", "")
    out = subprocess.run([sys.executable, "-c", _CHILD, str(root)],
                         capture_output=True, text=True, env=env, cwd=root)
    if out.returncode:
        raise RuntimeError(f"{root}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__.splitlines()[2].strip(), file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[2]
    other = Path(args[0]).resolve()
    b1, a1, a2, b2 = _run(other), _run(here), _run(here), _run(other)
    states = [key for key in a1 if key.startswith("K=")]
    same = {key: a1[key] == b1[key] == a2[key] == b2[key] for key in states}
    times = {key[3:]: {"other": [b1[key], b2[key]], "this": [a1[key], a2[key]]}
             for key in a1 if key.startswith("ms ")}
    print(json.dumps({"this": str(here), "other": str(other),
                      "identical": same, "ms (other, this, this, other)":
                      times, "sass_identical": a1["sass"] == b1["sass"],
                      "sass_instructions": [a1["sass_instructions"],
                                            b1["sass_instructions"]]}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
