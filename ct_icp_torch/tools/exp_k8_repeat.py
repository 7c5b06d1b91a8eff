"""K8 ``ct_ba_block`` launched many times on the same window, on the card:
does each launch repeat the first bit for bit?

    python -m ct_icp_torch.tools.exp_k8_repeat <other tree> [launches]
    python -m ct_icp_torch.tools.exp_k8_repeat --backend-window [rounds]

A launch's outputs depend on its inputs alone: no float atomics, the
CTAs' partial sums meet in rank order behind a cluster barrier, a frame
reads its neighbours' iterates once their iteration flags say they are
there, and the flags are left zero. A read ahead of its barrier or flag,
or flags left set, would show as a launch whose J^T J, J^T r, cost or
poses differ from another's on the same window.

``<other tree>`` is a checkout holding a ``ct_icp_torch`` package (e.g. a
``git archive`` of the parent commit). Each tree runs in its own process
with its own ``build/`` directory (``exp_ct_ba.run_child``), in the order
other, this, this, other. Inputs: ``exp_ct_ba``'s backend-shaped synthetic
windows (F = 8 and 4 keyframes of K = 4,096 rows, seed 0), one row in
``every`` weighing (1, 2, 4 or 32; the others weigh 0, which the kernel
skips), as drawn ("slerp") or with each frame's end rotation set to its
begin rotation ("nlerp": its poses then take the slerp's nlerp branch, as
the backend's first full window on the long drive does, and a row costs
less). The fewer and cheaper the rows, the shorter the row pass beside the
pose rows that rank 0's pose warp builds meanwhile: from the row warps
reaching the barrier after the pose warp (dense, slerp) through about
together (dense, nlerp, as on the backend's window) to well before it (1 in
32).
For each window, "gn" mode with 4 and 2 inner iterations, ``launches``
launches (default 1,500) back to back and as many with a 256 MB buffer
written before each (which also flushes the L2): the launches whose
outputs differ from the window's first launch, the largest such
difference, and the launches after which the iteration flags were not all
zero. Prints one JSON line per tree run and a summary line with the card's
name and power limit; exits 1 if any launch differed.

``--backend-window`` runs in this process, on this tree, what
``chip_smoke.py`` runs before its K8 check on the backend's window: the
long drive (its phase 7) and the backend gate (phase 8, with the CUDA
graphs of its refine's halves), which capture the first refine over a full
window (F = 8, K = 4,096, its poses on the nlerp branch). Then ``rounds``
rounds (default 200) of: the backend's CT-BA step timed as phase 8 times
it (a CUDA graph of 20 calls), ``kernels/checks.py::check_ct_ba_block`` in
"gn" mode with the backend's 4 inner iterations (two launches held bit
for bit, then against the plain version), and 100 launches held against
the first launch of the run. Prints the checks that failed and the
launches that differed, with the card's line; exits 1 if any did.
"""

import json
import sys
from pathlib import Path

from ct_icp_torch.tools.exp_ct_ba import card_line, run_child

_CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from ct_icp_torch.kernels import build, ct_ba_block as k8
from ct_icp_torch.parallel import ct_ba
assert build.__file__.startswith(sys.argv[1]), build.__file__
dev = torch.device("cuda", 0)
BETA, DAMPING = 1.0, 1e-3
N = int(sys.argv[2])


def window(f, k, every, nlerp, seed=0):
    rng = np.random.default_rng(seed)
    state, p, _ = ct_ba.build_synthetic_problem(rng, f, k, noise=0.02)
    w = rng.uniform(0.0, 0.5, (f, k)).astype(np.float32)
    w[:, np.arange(k) % every != 0] = 0.0

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
    if nlerp:
        state = state._replace(quat_end=state.quat_begin.clone())
        p = p._replace(prior_quat_end=p.prior_quat_begin.clone())
    state = ct_ba.CTBAState(*(x.to(dev) for x in state))
    p = ct_ba.CTBAProblem(*(x.contiguous().to(dev) for x in p))
    return ct_ba.pack_state(state), p


flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
runs = []
for f in (8, 4):
    for every, nlerp in ((1, False), (1, True), (2, True), (4, True),
                         (32, False), (32, True)):
        poses, p = window(f, 4096, every, nlerp)
        for iters in (4, 2):
            ref = k8.launch(poses, p, BETA, DAMPING, "gn", iters)
            flags = k8._flags[dev][:1 + f]
            for flushed in (False, True):
                bad = torch.zeros((), dtype=torch.int64, device=dev)
                dirty = torch.zeros((), dtype=torch.int64, device=dev)
                gap = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(N):
                    if flushed:
                        flush.fill_(i)
                    b = k8.launch(poses, p, BETA, DAMPING, "gn", iters)
                    diff = torch.stack([(b.poses - ref.poses).abs().max(),
                                        (b.jtj - ref.jtj).abs().max(),
                                        (b.jtr - ref.jtr).abs().max(),
                                        (b.cost - ref.cost).abs().max(),
                                        (b.total - ref.total).abs()]).max()
                    bad += diff != 0
                    gap = torch.maximum(gap, diff)
                    dirty += (flags != 0).any()
                torch.cuda.synchronize()
                runs.append(dict(F=f, every=every, nlerp=nlerp, iters=iters,
                                 flushed=flushed, launches=N,
                                 cluster=k8.cluster_size(f, 4096, dev),
                                 differing=int(bad), largest_gap=float(gap),
                                 flags_left_set=int(dirty)))
print(json.dumps({"tree": sys.argv[1], "runs": runs}))
'''


def backend_window(rounds: int) -> int:
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs
    from ct_icp_torch.kernels import build, checks
    from ct_icp_torch.kernels import ct_ba_block as k8
    from ct_icp_torch.parallel import ct_ba
    from ct_icp_torch.tools import bench as gates
    from ct_icp_torch.tools.timing import time_stateless

    dev = torch.device("cuda", 0)
    build.prepare()
    _, _, acq = cs.phase_long(dev)
    _, capture = cs.phase_backend(dev, acq)
    del acq
    problem = capture["problem"]
    poses = ct_ba.pack_state(ct_ba.CTBAState(*capture["args"][3:7]))
    o = gates.backend_profile(True).backend
    beta, iters = o.continuity_beta, 2 * o.num_steps
    step = cs.Odometry(gates.backend_profile(True), device=dev).backend.step
    state0 = ct_ba.CTBAState(*capture["args"][3:7])
    ref = k8.launch(poses, problem, beta, 1e-3, "gn", iters)
    failed, differing = [], 0
    for r in range(rounds):
        time_stateless(lambda: step(state0, problem)[0])
        try:
            checks.check_ct_ba_block(poses, problem, beta, 1e-3, "gn",
                                     iters=iters)
        except AssertionError as err:
            failed.append(f"round {r}: {err}")
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(100):
            b = k8.launch(poses, problem, beta, 1e-3, "gn", iters)
            bad += ((b.poses != ref.poses).any() | (b.jtj != ref.jtj).any()
                    | (b.jtr != ref.jtr).any() | (b.cost != ref.cost).any()
                    | (b.total != ref.total))
        differing += int(bad)
    print(json.dumps({"card": card_line(), "rounds": rounds,
                      "window": list(problem.raw.shape[:2]),
                      "cluster": k8.cluster_size(poses.shape[0],
                                                 problem.raw.shape[1], dev),
                      "checks_failed": failed,
                      "launches_differing": differing,
                      "launches": 100 * rounds}))
    return 1 if failed or differing else 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args and args[0] == "--backend-window":
        return backend_window(int(args[1]) if len(args) > 1 else 200)
    if len(args) not in (1, 2):
        print(__doc__.splitlines()[3].strip(), file=sys.stderr)
        return 2
    launches = args[1] if len(args) == 2 else "1500"
    here = Path(__file__).resolve().parents[2]
    other = Path(args[0]).resolve()
    differing = 0
    for name, root in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        res = run_child(_CHILD, root, launches)
        res["which"] = name
        print(json.dumps(res), flush=True)
        differing += sum(r["differing"] for r in res["runs"])
    print(json.dumps({"card": card_line(), "differing_launches": differing}))
    return 1 if differing else 0


if __name__ == "__main__":
    sys.exit(main())
