"""K10 ``level_normals`` of two source trees on the same lists, on the card:
what the kernel itself takes, beside the floor of a launch.

    python -m ct_icp_torch.tools.exp_normals <other tree>

``<other tree>`` is a checkout holding a ``ct_icp_torch`` package (e.g. a
``git archive`` of the parent commit). Each tree runs in its own process
with its own ``build/`` directory, in the order other, this, this, other.
Inputs, the same in both: the map of the room at 60,000 points a frame
after 60 frames with the backend and replay on (``datasets/room.py``, seed
47, 5 mm noise; ``tools/bench.py::run_room`` with
``room.replay_options(True)``, as ``chip_smoke.py`` phases 14-16 build
it), made by the first run and saved under ``build/``, and the last pose
as the export's location. The lists: each level's occupied slots (the
export's, ``voxel_map.occupied_slots``) and every refit slot of level 1
alone (the all-refit list, the dirty-slot refit's shape).

For each list and tree: the check against the plain version
(``kernels/checks.py::check_level_normals``), the kernel's duration in
torch.profiler's trace (one call, five times, each trace with 20 ms of
idle host time on each side of the call), a CUDA graph of 20 calls
(a call a list), the call with its host side (events around the
wrapper), the bytes the function needs and their bound; where the tree's
K10 has an empty kernel on its grid (``empty_launch``), the same two ways,
and where it picks the lanes a queued slot by the grid
(``level_normals.lanes``), the lanes of the list.
The registers and spills of each build (ptxas, the library built afresh).
Prints one JSON line a run and a summary line with the card.
"""

import json
import sys
from pathlib import Path

from ct_icp_torch.tools.exp_ct_ba import card_line, run_child

_CHILD = r'''
import json, os, re, statistics, sys, time
sys.path.insert(0, sys.argv[1])
cfg = json.loads(sys.argv[2])
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from ct_icp_torch.kernels import build, checks, level_normals as k10
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.tools.timing import bound, time_host, time_stateless
assert build.__file__.startswith(sys.argv[1]), build.__file__
dev = torch.device("cuda")
# built afresh, so that ptxas reports on this build
build._lib_path("level_normals").unlink(missing_ok=True)
build.build_all(["level_normals"])
regs = [x.strip() for x in build.build_info["level_normals"]["ptxas"]
        .splitlines() if re.search("registers|spill|Compiling", x)]

if not os.path.exists(cfg["map"]):
    from ct_icp_torch.datasets import room
    from ct_icp_torch.tools import bench as gates
    acq = room.make_acquisition(seed=room.REPLAY_SEED,
                                noise=room.REPLAY_NOISE, num_frames=60,
                                points_per_frame=60000)
    odo, _ = gates.run_room(room.replay_options(True), acq, 60)
    torch.save({"levels": [[t.cpu() for t in lv] for lv in odo.map_state],
                "location": torch.as_tensor(
                    odo.trajectory[-1].end_pose.tr - odo.origin,
                    dtype=torch.float32)}, cfg["map"])
    del odo
saved = torch.load(cfg["map"])
levels = [vm.MapLevel(*(t.to(dev) for t in lv)) for lv in saved["levels"]]
loc = saved["location"].to(dev)
lists = {f"level {li}": (lv, vm.occupied_slots(lv))
         for li, lv in enumerate(levels)}
lv1, occ1 = lists["level 1"]
refit1 = k10.refit_mask(lv1.keys[occ1.long()], lv1.count[occ1.long()])
lists["all-refit (level 1)"] = (lv1, occ1[refit1].contiguous())
torch.cuda.synchronize()


def kernel_us(fn, name, reps=5):
    # tools/timing.py::device_trace, which the parent tree does not have:
    # idle margins inside the trace, so that Kineto's window keeps the
    # kernel whatever the offset of the card's timestamps
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        d = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name]
        if d:
            out.append(sum(d))
    return out


def timed(fn, name):
    fn()
    us = kernel_us(fn, name)
    g20, _ = time_stateless(fn)
    return {"profiler_us": us,
            "profiler_us_median": statistics.median(us) if us else None,
            "graph20_ms": g20}


out = {"tree": sys.argv[1], "registers": regs, "lists": {}}
for lname, (lv, slots) in lists.items():
    err = checks.check_level_normals(lv, loc, slots)
    listed = slots.long()
    refit = k10.refit_mask(lv.keys[listed], lv.count[listed])
    s, n_refit = slots.shape[0], int(refit.sum())
    live = int(lv.count[listed][refit].clamp_max(lv.max_points).sum())
    n_bytes = s * 28 + (s - n_refit) * 16 + live * 12
    b_ms, b_by = bound(n_bytes, live * 21.0 + n_refit * 400.0)
    rec = {"S": s, "refit": n_refit, "points": live, "check": err,
           "bytes": n_bytes, "bound_ms": b_ms, "bound_by": b_by,
           "P": lv.max_points}
    rec.update(timed(lambda: vm.refit_normals(lv, loc, slots),
                     "level_normals"))
    rec["host_ms"], _ = time_host(lambda: vm.refit_normals(lv, loc, slots))
    if hasattr(k10, "empty_launch"):
        rec["empty"] = timed(lambda: k10.empty_launch(s), "empty")
    if hasattr(k10, "lanes"):
        rec["lanes"] = k10.lanes(s)
    out["lists"][lname] = rec
print(json.dumps(out))
'''


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__.splitlines()[3].strip(), file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[2]
    other = Path(args[0]).resolve()
    room_map = here / "build" / "exp_normals_room.pt"
    room_map.parent.mkdir(parents=True, exist_ok=True)
    cfg = json.dumps({"map": str(room_map)})
    runs = []
    for name, root in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        res = run_child(_CHILD, root, cfg)
        res["which"] = name
        print(json.dumps(res), flush=True)
        runs.append(res)
    summary = {
        f"{r['which']} {i}": {
            lname: {"profiler_us_median": rec["profiler_us_median"],
                    "graph20_ms": rec["graph20_ms"],
                    "empty_us": (rec.get("empty") or {}).get(
                        "profiler_us_median"),
                    "lanes": rec.get("lanes")}
            for lname, rec in r["lists"].items()}
        for i, r in enumerate(runs)}
    print(json.dumps({"card": card_line(), "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
