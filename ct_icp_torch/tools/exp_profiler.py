"""What torch.profiler sees of the port's kernel launches, on the card,
with and without idle margins inside the trace.

    python -m ct_icp_torch.tools.exp_profiler [reps] [--seconds S]
                                              [--untraced U]

Two processes, one for the libraries as ``kernels/build.py`` builds them
(nvcc's static CUDA runtime in each) and one for the libraries linked
against the shared runtime (``-cudart shared``: the runtime torch loaded),
each built into its own ``build/`` names (the flags are in the library's
hash). Each process traces ``reps`` times (default 6) each of
``rebuild_level`` on a street level of 2^14 slots (one K7 cooperative
launch, then one K6 launch: ``tests/test_torch_kernels_gpu.py::
test_rebuild_level_is_one_k7_and_one_k6_operation``'s call) and
``evict_voxels`` on a restored copy (one K9 launch), after a warm-up call,
two ways: a trace that ends with the call's synchronize, as that test
traces, and one with 20 ms of idle host time on each side of the call
(``tools/timing.py::device_trace``). With ``--seconds S`` each process
goes on for S seconds, running the two calls between rounds of traces
every 4 s, so that the later rounds are an older process's. With
``--untraced U`` each process first runs the two calls for U seconds
with no trace (a process that is old at its first trace). For every
trace: the seconds since the process started, which kernels it saw and,
for each kernel seen, its start less its launch call's start (the raw
Kineto events of the same correlation id). Prints one JSON line a process
and a summary line with the card.
"""

import json
import sys
from pathlib import Path

from ct_icp_torch.tools.exp_ct_ba import card_line, run_child

_CHILD = r'''
import json, sys, time
T0 = time.time()
sys.path.insert(0, sys.argv[1])
cfg = json.loads(sys.argv[2])
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from ct_icp_torch.kernels import build
build.NVCC_FLAGS = build.NVCC_FLAGS + tuple(cfg["flags"])
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.tools.timing import PROFILE_MARGIN_S
assert build.__file__.startswith(sys.argv[1]), build.__file__
dev = torch.device("cuda")
build.build_all(["rebuild_claim", "row_gather", "evict_voxels",
                 "map_insert", "candidate_gather"])
rng = np.random.default_rng(3)
n = 20000
pts = torch.from_numpy(np.concatenate([
    np.stack([rng.uniform(-20, 20, n), rng.uniform(-10, 10, n),
              rng.normal(scale=0.02, size=n)], -1),
    np.stack([rng.uniform(-20, 20, n),
              np.where(rng.uniform(size=n) < .5, -10.0, 10.0),
              rng.uniform(0, 6, n)], -1)]).astype(np.float32)).to(dev)
ok = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
level = vm.make_level(14, 30, dev)
vm.insert_points(level, pts, ok, 0.8, 0.1, max_rounds=12)
shift = torch.tensor([2.3, -0.7, 0.1], device=dev)
work = vm.MapLevel(*(t.clone() for t in level))
coords = torch.unique(torch.trunc(pts / 0.8).to(torch.int32), dim=0)[:512]
coords_ok = torch.ones(coords.shape[0], dtype=torch.bool, device=dev)


def restore():
    for t, s in zip(work, level):
        t.copy_(s)


CASES = {
    "rebuild_level (K7 + K6)": (lambda: vm.rebuild_level(level, shift, 0.8),
                                ("rebuild_claim", "row_gather")),
    "evict_voxels (K9)": (lambda: vm.evict_voxels(work, coords, coords_ok),
                          ("evict",)),
}


def trace(fn, want, margin):
    restore()
    fn()
    restore()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        fn()
        torch.cuda.synchronize()
        time.sleep(margin)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    raw = prof.profiler.kineto_results.events()
    launch = {e.correlation_id(): e.start_ns() for e in raw
              if "aunch" in e.name() and "CPU" in str(e.device_type())}
    lag = [round((e.start_ns() - launch[e.correlation_id()]) / 1e3, 3)
           for e in raw if "CUDA" in str(e.device_type())
           and e.correlation_id() in launch]
    return {"t_s": round(time.time() - T0, 1),
            "seen": {w: any(w in x for x in names) for w in want},
            "launch_to_kernel_us": lag}


def busy(seconds):
    t_gap = time.time()
    while time.time() - t_gap < seconds:
        restore()
        vm.insert_points(work, pts[:4000], ok[:4000], 0.8, 0.1, 12)
        vm.rebuild_level(level, shift, 0.8)
        torch.cuda.synchronize()


busy(cfg["untraced"])
traces = []
while True:
    for name, (fn, want) in CASES.items():
        for margin in (0.0, PROFILE_MARGIN_S):
            for _ in range(cfg["reps"]):
                traces.append(dict(case=name, margin_s=margin,
                                   **trace(fn, want, margin)))
    if time.time() - T0 >= cfg["seconds"]:
        break
    busy(4.0)
summary = {}
for name in CASES:
    for margin in (0.0, PROFILE_MARGIN_S):
        mine = [t for t in traces
                if t["case"] == name and t["margin_s"] == margin]
        summary[f"{name}, margins {margin} s"] = {
            "traces": len(mine),
            "all_seen": sum(all(t["seen"].values()) for t in mine)}
print(json.dumps({"config": cfg, "torch": torch.__version__,
                  "cuda": torch.version.cuda, "summary": summary,
                  "traces": traces}))
'''

CONFIGS = (
    {"name": "static cudart (kernels/build.py)", "flags": []},
    {"name": "shared cudart", "flags": ["-cudart", "shared"]},
)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    opts = {"seconds": 0.0, "untraced": 0.0}
    for name in opts:
        if f"--{name}" in args:
            i = args.index(f"--{name}")
            opts[name] = float(args[i + 1])
            args = args[:i] + args[i + 2:]
    reps = int(args[0]) if args else 6
    here = Path(__file__).resolve().parents[2]
    summary = {}
    for cfg in CONFIGS:
        res = run_child(_CHILD, here, json.dumps(
            {**cfg, "reps": reps, **opts}))
        print(json.dumps(res), flush=True)
        summary[cfg["name"]] = res["summary"]
    print(json.dumps({"card": card_line(), "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
