"""K5's cost law on the card: where the time of an LM step goes.

    python3 -m ct_icp_torch.tools.exp_lm_loop [--steps 20]

Times one ``lm_loop`` call (a CUDA graph of its one launch, the state
restored before each replay) on synthetic point-to-plane problems of K rows
(a street-like scene, 3/4 of the rows kept, a moving pose, every prior beta
set), for the main path's cluster of 16 CTAs and a variant of the kernel
built for 8 (``-DK5_CLUSTER=8``), and divides by the steps the call ran
(the kernel's device count): the two sum in another order, so they may run
different numbers of steps, and only their times a step compare. K = 0 has
no rows: every step is rejected, so the call runs all its steps, and its
time a step is the step's serial chain alone (the pose's tangents, the
prior rows, the cluster sums and barriers, the 12x12 solve, accept/reject).
The rows' share of a step at K is the difference. K = rows_on_chip + 1000
reads its rows from global memory. A variant built with ``-DK5_MARKS``
(16 CTAs) counts CTA 0's clock cycles in each phase of a step, which give
each phase's share of the step. Prints one JSON line per shape and the
card's line.
"""

import argparse
import json
import subprocess

import numpy as np
import torch

from ct_icp_torch.config.options import LeastSquares
from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import lm_step as k5
from ct_icp_torch.tools.timing import time_graph

SIGMA = np.float32(0.2)
ARGS = (LeastSquares.CAUCHY, SIGMA, 0.0, False)
# the kernel's builds: the main path's, and the measurement variants
MAIN, EIGHT, MARKS = (), ("K5_CLUSTER=8",), ("K5_MARKS",)
# the phases of a step, in the order of csrc/lm_step.cu's MARK sites
PHASES = ("column threads", "row pass", "barrier 1", "cluster sums",
          "J^T W J assembly", "scaling + solve", "trial pose",
          "trial-cost pass", "barrier 2", "accept/reject")


def problem(rng, k, dev):
    """K rows on a ground and two walls, anchors on the planes, 3/4 kept;
    a begin / end pose 0.8 deg apart; a prior with every beta set."""
    n_ground = k // 2
    g = np.stack([rng.uniform(-20, 20, n_ground),
                  rng.uniform(-10, 10, n_ground),
                  rng.normal(scale=0.02, size=n_ground)], -1)
    n_wall = k - n_ground
    w = np.stack([rng.uniform(-20, 20, n_wall),
                  np.where(rng.uniform(size=n_wall) < .5, -10.0, 10.0),
                  rng.uniform(0, 6, n_wall)], -1)
    pts = np.concatenate([g, w]).astype(np.float32)
    anchors = pts + rng.normal(scale=0.03, size=pts.shape).astype(np.float32)
    normals = rng.normal(size=pts.shape).astype(np.float32)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                          1e-6)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    ok = t(rng.uniform(size=k) < 0.75)
    rows = k5.pack_rows(t(pts), t(rng.uniform(0, 1, k).astype(np.float32)),
                        t(anchors), t(normals),
                        t(rng.uniform(0.2, 1.0, k).astype(np.float32)), ok)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    state = k5.init_state(f([1.0, 0, 0, 0]), f([0.02, -0.01, 0.0]),
                          torch.nn.functional.normalize(
                              f([0.99997, 0.001, -0.002, 0.007]), dim=0),
                          f([0.35, 0.04, 0.01]))
    prior = f([1.0, 0, 0, -0.001, -0.02, 0, 0, 0.3, 0.0, 0, 0.001, 0.01,
               0.001, 0.0005])
    return rows, prior, ok.sum(dtype=torch.int32), state


def time_call(rows, prior, n_res, state0, steps, defines):
    """(device ms of one call of the build ``defines``, steps it ran)."""
    st = state0.clone()
    counter = k5.steps_counter(rows.device)
    before = int(counter[0])
    k5.launch(rows, prior, n_res, st, steps, *ARGS, defines=defines)
    ran = int(counter[0]) - before
    ms, _ = time_graph(lambda: st.copy_(state0),
                       lambda: k5.launch(rows, prior, n_res, st, steps,
                                         *ARGS, defines=defines))
    return ms, ran


def phase_shares(rows, prior, n_res, state0, steps):
    """Each phase's share of the clock cycles of one call's steps."""
    read = build.launcher("lm_step", "k5_read_marks", (build.PTR,),
                          k5.library(k5.Family.PLANE, MARKS))
    cycles = np.zeros(len(PHASES), dtype=np.int64)
    build.check_status(read(cycles.ctypes.data), "k5_read_marks")
    k5.launch(rows, prior, n_res, state0.clone(), steps, *ARGS,
              defines=MARKS)
    torch.cuda.synchronize()
    build.check_status(read(cycles.ctypes.data), "k5_read_marks")
    return dict(zip(PHASES, (cycles / cycles.sum()).tolist()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_lm_loop: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    build.prepare()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    for k in (0, 1350, 2941, 4096, 16384, k5.rows_on_chip() + 1000):
        rows, prior, n_res, state = problem(rng, k, dev)
        rec = {"K": k, "kept": int(n_res), "n_steps": args.steps}
        for cluster, defines in ((8, EIGHT), (16, MAIN)):
            ms, ran = time_call(rows, prior, n_res, state, args.steps,
                                defines)
            rec[f"cluster {cluster}"] = {"call_ms": ms, "steps_run": ran,
                                         "ms_per_step": ms / max(ran, 1)}
        rec["one_step_call_ms"] = time_call(rows, prior, n_res, state, 1,
                                            MAIN)[0]
        rec["phase_share"] = phase_shares(rows, prior, n_res, state,
                                          args.steps)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()
