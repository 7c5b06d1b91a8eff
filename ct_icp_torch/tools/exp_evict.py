"""K9 ``evict_voxels`` of two source trees on the same map, on the card:
what the kernel itself takes, beside the floor of a launch.

    python -m ct_icp_torch.tools.exp_evict <other tree>

``<other tree>`` is a checkout holding a ``ct_icp_torch`` package (e.g. a
``git archive`` of the parent commit). Each tree runs in its own process
with its own ``build/`` directory, in the order other, this, this, other.
Inputs, the same in both: the replay gate's three-level map (the default
profile's levels: 0.2 m x 50 points at 2^20 slots, 0.5 m x 40 at 2^19,
1.5 m x 40 at 2^17) holding the room's frames 0-5 (``datasets/room.py``,
seed 47, 5 mm noise, 60,000 points a frame) at their true poses, inserted
by K3; each level's evict list is the distinct voxels of frames 1-5's
world points (the first replay of the 60,000-point room), padded to a
power of two.

For each level and tree, one eviction's time three ways:
  * ``profiler_us``: the kernel's duration in torch.profiler's trace (one
    call on a restored copy, five times, 20 ms of idle host time on each
    side inside the trace; what the card itself takes);
  * ``graph20_ms``: a CUDA graph of 20 calls on an already evicted copy,
    divided by 20 (eviction is idempotent: the same probes, exchanges and
    stores, nothing removed);
  * ``one_call_graph_ms``: one call replayed from a graph between two
    events after a restore (``tools/timing.py::time_graph``; it includes
    the graph's submission).
Where the tree has the one-launch eviction over every level
(``voxel_map.evict_levels``), the same for it. Where the tree's K9 has an
empty kernel (``k9_empty``), the empty kernel on level 0's grid, and on
the all-level grid, the first two ways: the floor of each method. Prints
one JSON line a run and a summary line with the card.
"""

import json
import sys
from pathlib import Path

from ct_icp_torch.tools.exp_ct_ba import card_line, run_child

_CHILD = r'''
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from ct_icp_torch.datasets import room
from ct_icp_torch.kernels import build, evict_voxels as k9
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.odometry.odometry import _pad_pow2, _unique_voxels
from ct_icp_torch.tools.timing import time_graph, time_stateless
assert build.__file__.startswith(sys.argv[1]), build.__file__
dev = torch.device("cuda")
build.build_all(["evict_voxels", "map_insert"])
acq = room.make_acquisition(seed=room.REPLAY_SEED, noise=room.REPLAY_NOISE,
                            num_frames=25, points_per_frame=60000)
world = []
for i in range(6):
    fr = acq.frame(i)
    world.append(fr["begin_pose"].continuous_transform(
        fr["xyz"], fr["end_pose"], fr["timestamps"]))
res = room.replay_options(True).map_options.resolutions
levels = []
for rp in res:
    lv = vm.make_level(rp.capacity_log2, rp.max_num_points, dev)
    for w in world:
        pts = torch.as_tensor(w, dtype=torch.float32, device=dev)
        vm.insert_points(lv, pts, torch.ones(pts.shape[0], dtype=torch.bool,
                                             device=dev), rp.resolution,
                         rp.min_distance_between_points, 12)
    levels.append(lv)
old = np.concatenate(world[1:], axis=0)
arrays, counts = [], []
for rp in res:
    c = _unique_voxels(np.trunc(old / rp.resolution).astype(np.int32))
    arrays.append(torch.as_tensor(_pad_pow2(c), device=dev))
    counts.append(int(c.shape[0]))
torch.cuda.synchronize()


def copy(lv):
    return vm.MapLevel(*(t.clone() for t in lv))


def restore(work, saved):
    for t, s in ((work.count, saved.count), (work.nflags, saved.nflags),
                 (work.num_points, saved.num_points)):
        t.copy_(s)


def kernel_us(fn, reset, name, reps=5):
    # tools/timing.py::time_kernels, which the parent tree does not have
    out = []
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)       # idle margins: tools/timing.py
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        d = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name]
        if d:
            out.append(sum(d))
    return out


def three_ways(fn, reset, name):
    us = kernel_us(fn, reset, name)
    one, _ = time_graph(reset, fn)
    reset()
    g20, how = time_stateless(fn)          # warm-up calls evict first
    return {"profiler_us": us,
            "profiler_us_median": statistics.median(us) if us else None,
            "graph20_ms": g20, "graph20_timing": how,
            "one_call_graph_ms": one}


out = {"tree": sys.argv[1], "levels": []}
for li, lv in enumerate(levels):
    coords = arrays[li]
    valid = torch.arange(coords.shape[0], device=dev) < counts[li]
    work = copy(lv)
    rec = {"M": coords.shape[0], "valid": counts[li],
           "occupied": int((lv.count > 0).sum())}
    rec.update(three_ways(lambda: vm.evict_voxels(work, coords, valid),
                          lambda: restore(work, lv), "evict"))
    out["levels"].append(rec)
if hasattr(vm, "evict_levels"):
    works = [copy(lv) for lv in levels]

    def reset_all():
        for w_, s_ in zip(works, levels):
            restore(w_, s_)

    before = k9.launches
    vm.evict_levels(works, arrays, counts)
    out["evict_levels_launches"] = k9.launches - before
    out["all_levels"] = three_ways(
        lambda: vm.evict_levels(works, arrays, counts), reset_all, "evict")
if hasattr(k9, "empty_launch"):
    grids = {"level 0": k9.grid_blocks(counts[:1]),
             "all levels": k9.grid_blocks(counts)}
    out["empty"] = {}
    for gname, blocks in grids.items():
        fn = lambda: k9.empty_launch(blocks)
        us = kernel_us(fn, lambda: None, "empty")
        g20, how = time_stateless(fn)
        one, _ = time_graph(lambda: None, fn)
        out["empty"][gname] = {
            "grid": blocks, "profiler_us": us,
            "profiler_us_median": statistics.median(us) if us else None,
            "graph20_ms": g20, "one_call_graph_ms": one}
print(json.dumps(out))
'''


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__.splitlines()[3].strip(), file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[2]
    other = Path(args[0]).resolve()
    for name, root in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        res = run_child(_CHILD, root)
        res["which"] = name
        print(json.dumps(res), flush=True)
    print(json.dumps({"card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
