"""K8 ``ct_ba_block`` of two source trees on the same CT-BA windows, on the
card: device times, host times, the phase split and the poses.

    python -m ct_icp_torch.tools.exp_ct_ba <other tree>

``<other tree>`` is a checkout holding a ``ct_icp_torch`` package (e.g. a
``git archive`` of the parent commit). Each tree runs in its own process
with its own ``build/`` directory, in the order other, this, this, other,
so both trees' times come from one card and one process order. Inputs:
synthetic windows shaped like the backend gate's (F = 8 and 6 keyframes of
K = 4,096 rows, ``parallel/ct_ba.py::build_synthetic_problem`` with the
backend's prior weight, prior poses moved off the state, uniform row
weights; one numpy generator, seed 0).

For each window and tree: K8 in ``gn`` mode (one inner iteration; 2 and 4
where the tree's wrapper takes ``iters``) and ``blocks`` mode, on the
device (a CUDA graph of 20 calls) and with its host side (events around
the wrapper); ``make_ct_ba_step``'s jacobi step of 2 inner iterations, and
the backend's CT-BA work of a refine (2 steps of 2, or one step of 4 where
the backend folds them), the same two ways. Where the tree's kernel has a
``-DK8_MARKS`` variant (``kernels/ct_ba_block.py::MARK_PHASES``), one
launch of it gives the clock cycles of each phase for the CTAs it marks;
and each of the tree's other variant builds (``VARIANTS``), timed.
The registers and spills of each build (ptxas, the library built afresh)
and its SASS's local-memory loads and stores (cuobjdump). The poses of the
backend's refine and their largest difference between the trees. Prints
one JSON line per run and a summary line with the card's name and power
limit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

_CHILD = r'''
import inspect, json, re, subprocess, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from ct_icp_torch.kernels import build, ct_ba_block as k8
from ct_icp_torch.parallel import ct_ba
from ct_icp_torch.tools.timing import time_host, time_stateless
assert build.__file__.startswith(sys.argv[1]), build.__file__
dev = torch.device("cuda")
BETA, DAMPING = 1.0, 1e-3
phases = getattr(k8, "MARK_PHASES", None)
builds = [()] + ([("K8_MARKS",)] if phases is not None else [])
regs = {}
for defines in builds:
    # built afresh, so that ptxas reports on this build
    build._lib_path("ct_ba_block", defines).unlink(missing_ok=True)
    build.build_all(["ct_ba_block"], defines)
    info = build.build_info[" ".join(("ct_ba_block",) + defines)]["ptxas"]
    name = " ".join(("ct_ba_block",) + defines)
    regs[name] = [x.strip() for x in info.splitlines()
                  if re.search("registers|spill|Function properties", x)]
    sass = subprocess.run(["cuobjdump", "-sass",
                           str(build._lib_path("ct_ba_block", defines))],
                          capture_output=True, text=True).stdout
    ins = [x for x in sass.splitlines() if re.search(r"/\*[0-9a-f]{4,}\*/", x)]
    regs[name + " sass"] = {"instructions": len(ins),
                            "local loads": sum("LDL" in x for x in ins),
                            "local stores": sum("STL" in x for x in ins)}


def window(f, k, seed=0):
    rng = np.random.default_rng(seed)
    state, p, _ = ct_ba.build_synthetic_problem(rng, f, k, noise=0.02)
    w = rng.uniform(0.0, 0.5, (f, k)).astype(np.float32)

    def moved(x, scale):
        return x + torch.from_numpy(rng.normal(
            scale=scale, size=tuple(x.shape)).astype(np.float32))

    p = p._replace(weights=torch.from_numpy(w),
                   prior_tr_begin=moved(p.prior_tr_begin, 0.01),
                   prior_tr_end=moved(p.prior_tr_end, 0.01),
                   prior_quat_begin=moved(p.prior_quat_begin, 0.003),
                   prior_quat_end=moved(p.prior_quat_end, 0.003),
                   prior_weight=torch.full((f,), 1.5),
                   edge_alpha=torch.ones(f))
    state = ct_ba.CTBAState(*(x.to(dev) for x in state))
    p = ct_ba.CTBAProblem(*(x.contiguous().to(dev) for x in p))
    return state, p


def both(fn):
    d, how = time_stateless(fn)
    h, _ = time_host(fn)
    return {"device_ms": d, "timing": how, "host_ms": h}


takes_iters = "iters" in inspect.signature(k8.ct_ba_block).parameters
out = {"tree": sys.argv[1], "registers": regs, "windows": {}}
for f in (8, 6):
    state, p = window(f, 4096)
    poses = ct_ba.pack_state(state)
    rec = {}
    for mode, iters in (("gn", 1), ("gn", 2), ("gn", 4), ("blocks", 1)):
        if iters > 1 and not takes_iters:
            continue
        kw = {"iters": iters} if takes_iters else {}
        rec[f"{mode} x{iters}"] = both(
            lambda: k8.ct_ba_block(poses, p, BETA, DAMPING, mode, **kw))
    step2 = ct_ba.make_ct_ba_step(num_inner_iters=2, beta=BETA,
                                  damping=DAMPING)
    step4 = ct_ba.make_ct_ba_step(num_inner_iters=4, beta=BETA,
                                  damping=DAMPING)

    def two_steps():
        s = state
        for _ in range(2):
            s, c = step2(s, p)
        return s, c

    rec["step of 2"] = both(lambda: step2(state, p))
    rec["2 steps of 2"] = both(two_steps)
    rec["step of 4"] = both(lambda: step4(state, p))
    before = k8.launches
    s4, c4 = two_steps()
    rec["launches, 2 steps of 2"] = k8.launches - before
    torch.cuda.synchronize()
    rec["poses after 2 steps of 2"] = ct_ba.pack_state(s4).cpu().tolist()
    rec["cost"] = float(c4)
    if hasattr(k8, "cluster_size"):
        rec["cluster"] = k8.cluster_size(f, 4096, dev, waits=False)
    for vname, defines in getattr(k8, "VARIANTS", {}).items():
        for iters in (1, 2):
            rec[f"variant {vname}: gn x{iters} device_ms"] = time_stateless(
                lambda: k8.launch(poses, p, BETA, DAMPING, "gn", iters,
                                  defines=defines))[0]
    if phases is not None:
        marks = ("K8_MARKS",)
        read = build.launcher("ct_ba_block", "k8_read_marks", (build.PTR,),
                              marks)
        cyc = np.zeros(getattr(k8, "MARK_SLOTS", 2) * len(phases), np.int64)
        build.check_status(read(cyc.ctypes.data), "k8_read_marks")
        for mode, iters in (("gn", 1), ("gn", 2), ("blocks", 1)):
            if iters > 1 and not takes_iters:
                continue
            kw = {"iters": iters} if takes_iters else {}
            k8.launch(poses, p, BETA, DAMPING, mode, defines=marks, **kw)
            torch.cuda.synchronize()
            build.check_status(read(cyc.ctypes.data), "k8_read_marks")
            rows = cyc.reshape(-1, len(phases)).tolist()
            rec[f"marks {mode} x{iters}"] = [dict(zip(phases, r))
                                              for r in rows]
    out["windows"][f"F={f} K=4096"] = rec
print(json.dumps(out))
'''


def run_child(child: str, root: Path, *args: str) -> dict:
    """Run the program ``child`` in a process of its own on the tree
    ``root`` (its ``ct_icp_torch`` first on the path, its own ``build/``;
    ``args`` follow the tree on its command line), and return the JSON of
    its last line."""
    env = dict(os.environ)
    cuda_bin = os.path.join(env.get("CUDA_HOME", "/usr/local/cuda"), "bin")
    env["PATH"] = cuda_bin + os.pathsep + env.get("PATH", "")
    out = subprocess.run([sys.executable, "-c", child, str(root), *args],
                         capture_output=True, text=True, env=env, cwd=root)
    if out.returncode:
        raise RuntimeError(f"{root}: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def pose_gap(a, b) -> float:
    """Largest absolute difference of two trees' pose lists."""
    return max(abs(x - y) for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__.splitlines()[3].strip(), file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[2]
    other = Path(args[0]).resolve()
    runs = []
    for name, root in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        res = run_child(_CHILD, root)
        res["which"] = name
        print(json.dumps(res), flush=True)
        runs.append(res)
    gaps = {w: pose_gap(runs[0]["windows"][w]["poses after 2 steps of 2"],
                        runs[1]["windows"][w]["poses after 2 steps of 2"])
            for w in runs[0]["windows"]}
    print(json.dumps({"card": card_line(), "pose_gap_between_trees": gaps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
