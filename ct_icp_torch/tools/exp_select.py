"""K12 ``knn_search`` and K13 ``exact_sample`` of two source trees on the
same inputs, on the card.

    python -m ct_icp_torch.tools.exp_select <other tree>

``<other tree>`` is a checkout holding a ``ct_icp_torch`` package (e.g. a
``git archive`` of the parent commit into a directory ``.gitignore`` lists,
such as ``build/parent``). Each tree runs in its own process, with its
``ct_icp_torch`` first on the path and its own ``build/`` directory, in the
order other, this, this, other.

Inputs, the same for both trees: made first by this tree in a process of
its own and saved to ``build/exp_select_inputs.pt``, as ``chip_smoke.py``
takes its kernels' first calls:

- K13 on the staged path's first calls (phase 29's shapes): the driving
  corridor (80-frame trajectory, seed ``APE_SEEDS[0]``) through
  ``register_frame`` with ADAPTIVE keypoints, frame 1's raw scan
  (N = 65,536); and with 2 points a voxel and the 3,000-point cap;
- K12 on the knn run's first call (phase 25's shape: the corridor's first
  16 frames streamed with ``ball_neighborhood=False``; M = 1,350, O = 27,
  k = 40), and on the card test's nv = 3 input (``test_torch_kernels_gpu.py
  ::test_knn_search_matches_plain``: 1,800 queries on a level of 40,000
  points, O = 343, scalar radius 1.0, k = 40).

For each input and tree: the kernel against its plain version bit for bit
(``kernels/checks.py``), a SHA-256 of its outputs, and its time on the
device with the L2 flushed before each call (``timing.time_cold``), back to
back in a CUDA graph of 20 (``timing.time_stateless``) and with its host
side (``timing.time_host``), beside the bound (bytes, counted as
``chip_smoke.py`` counts them). Each tree's two libraries are built afresh,
so that ptxas's registers, shared memory and spills are this build's.
Where the tree's K12 takes ``K12_SPLIT`` (warps a query), its variants of
1, 2 and 4 warps other than its own are built and timed the same way
(``knn_search.launch``). Beside
K12, ``torch.topk(key, k, largest=False, sorted=True)`` on the prebuilt
[M, O * P] int64 keys of the plain version: the selection alone, not the
gather; a yardstick that the port never calls. Prints one JSON line a run
and a summary with the card's name and power limit. Needs one CUDA device.
"""

import json
import sys
from pathlib import Path

from ct_icp_torch.tools.exp_ct_ba import card_line, run_child

_MAKE = r'''
import dataclasses, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from ct_icp_torch.config.options import (AdaptiveGridSamplingOptions,
                                         SamplingOption,
                                         default_driving_profile)
from ct_icp_torch.datasets import corridor as cor
from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import exact_sample as k13
from ct_icp_torch.kernels import knn_search as k12
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.odometry.odometry import Odometry
dev = torch.device("cuda")
build.prepare()
frames = cor.render_corridor(cor.build_scene(),
                             cor.straight_trajectory(400, 80 * 0.1 + 0.5),
                             16, cor.APE_SEEDS[0])


def first_call(module, name, run):
    inner, seen = getattr(module, name), []

    def spy(*args, **kw):
        if not seen:
            seen.append(([a.clone() if torch.is_tensor(a) else a
                          for a in args], dict(kw)))
        return inner(*args, **kw)

    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, inner)
    return seen[0]


d = default_driving_profile()
inputs = {}
for tag, opts in (
        ("K13 adaptive frame 1", dataclasses.replace(
            d, sampling=SamplingOption.ADAPTIVE)),
        ("K13 k=2 cap frame 1", dataclasses.replace(
            d, sampling=SamplingOption.ADAPTIVE,
            adaptive_options=AdaptiveGridSamplingOptions(
                num_points_per_voxel=2, max_num_points=3000)))):
    odo = Odometry(opts, device=dev)
    args, kw = first_call(k13, "exact_sample", lambda: [
        odo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
        for i, f in enumerate(frames[:2])])
    names = ("voxel_size", "bands", "k", "max_keep")
    kw = {**dict(zip(names, args[3:])), **kw}
    inputs[tag] = dict(points=args[0], valid=args[1], capacity=args[2],
                       kw={k: v for k, v in kw.items() if v is not None})

odo = Odometry(dataclasses.replace(d, ct_icp_options=dataclasses.replace(
    d.ct_icp_options, ball_neighborhood=False)), device=dev)
preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
         for i, f in enumerate(frames)]
args, kw = first_call(k12, "knn_search",
                      lambda: list(odo.stream_frames(iter(preps),
                                                     batch=16)))
inputs["K12 knn frame 1"] = dict(zip(
    ("points", "slots", "cnt_ok", "queries", "radius", "k"), args))

# the card test's nv = 3 input (test_knn_search_matches_plain)
rng = np.random.default_rng(33)


def scene(n):
    g = np.stack([rng.uniform(-20, 20, n), rng.uniform(-10, 10, n),
                  rng.normal(scale=0.02, size=n)], -1)
    w = np.stack([rng.uniform(-20, 20, n),
                  np.where(rng.uniform(size=n) < .5, -10.0, 10.0),
                  rng.uniform(0, 6, n)], -1)
    return np.concatenate([g, w]).astype(np.float32)


level = vm.make_level(14, 30, dev)
pts = torch.from_numpy(scene(20000)).to(dev)
vm.insert_points(level, pts, torch.ones(pts.shape[0], dtype=torch.bool,
                                        device=dev), 0.8, 0.1, max_rounds=12)
q = torch.from_numpy(scene(900)).to(dev)
valid = torch.from_numpy(rng.uniform(size=q.shape[0]) < 0.95).to(dev)
slots, cnt = vm.gather_candidate_planes(level, q, valid, 0.8, 3)
inputs["K12 O=343 (card test nv=3)"] = dict(
    points=level.points.clone(), slots=slots, cnt_ok=cnt, queries=q,
    radius=1.0, k=40)
torch.save({tag: {k: v.cpu() if torch.is_tensor(v) else v
                  for k, v in rec.items()} for tag, rec in inputs.items()},
           sys.argv[2])
print("{}")
'''

_CHILD = r'''
import hashlib, json, re, sys
sys.path.insert(0, sys.argv[1])
cfg = json.loads(sys.argv[2])
import torch
from ct_icp_torch.kernels import build, checks
from ct_icp_torch.kernels import exact_sample as k13
from ct_icp_torch.kernels import knn_search as k12
from ct_icp_torch.tools.exp_moments import live_work
from ct_icp_torch.tools.timing import bound, time_cold, time_host, \
    time_stateless
assert build.__file__.startswith(sys.argv[1]), build.__file__
dev = torch.device("cuda")
regs = {}
for name in ("knn_search", "exact_sample"):
    # built afresh, so that ptxas reports on this build
    build._lib_path(name).unlink(missing_ok=True)
    build.build_all([name])
    regs[name] = [x.strip() for x in build.build_info[name]["ptxas"]
                  .splitlines() if re.search("registers|spill|Compiling", x)]
# the warps a query of this tree's K12, where it takes K12_SPLIT; the other
# splits are built and timed as variants
split = ("K12_SPLIT" in (build.CSRC / "knn_search.cu").read_text()
         and build.launcher("knn_search", "k12_split", ())())
variants = [(f"K12_SPLIT={s}",) for s in (1, 2, 4) if split and s != split]
for d in variants:
    build._lib_path("knn_search", d).unlink(missing_ok=True)
    build.build_all(["knn_search"], d)
    key = " ".join(("knn_search",) + d)
    regs[key] = [x.strip() for x in build.build_info[key]["ptxas"]
                 .splitlines() if re.search("registers|spill|Compiling", x)]
inputs = torch.load(cfg["inputs"], weights_only=False)


def on_card(rec):
    return {k: v.to(dev) if torch.is_tensor(v) else v for k, v in rec.items()}


def digest(outs):
    h = hashlib.sha256()
    for t in outs:
        h.update(t.reshape(-1).contiguous().view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def times(fn):
    cold, _ = time_cold(fn)
    warm, _ = time_stateless(fn)
    host, _ = time_host(fn)
    return {"ms": cold, "warm_ms": warm, "host_ms": host}


out = {"tree": sys.argv[1], "registers": regs, "k12_split": split,
       "inputs": {}}
for tag, rec in inputs.items():
    rec = on_card(rec)
    if tag.startswith("K13"):
        pts, valid, cap, kw = (rec["points"], rec["valid"], rec["capacity"],
                               rec["kw"])
        chk = checks.check_exact_sample(pts, valid, cap, **kw)
        n = pts.shape[0]
        b_ms, b_by = bound(n * 13 + cap * 5 + 4, 0.0)
        r = {"shape": f"N={n} valid={int(valid.sum())} capacity={cap} "
                      f"{kw.get('k', 1)} a voxel max_keep="
                      f"{kw.get('max_keep', 0)} kept={chk['count']}",
             "digest": digest(k13.exact_sample(pts, valid, cap, **kw)),
             "bound_ms": b_ms, "bound_by": b_by}
        r.update(times(lambda: k13.exact_sample(pts, valid, cap, **kw)))
    else:
        args = tuple(rec[k] for k in ("points", "slots", "cnt_ok",
                                      "queries", "radius", "k"))
        points, slots, cnt, q, radius, k = args
        chk = checks.check_knn_search(*args)
        m = q.shape[0]
        points_read, _rows, live = live_work(points, slots, cnt)
        n_bytes = (points_read * 12 + slots.numel() * 8 + m * 12
                   + (m * 4 if torch.is_tensor(radius) else 0) + m * k * 17)
        b_ms, b_by = bound(n_bytes, live * 8.0)
        r = {"shape": f"M={m} O={slots.shape[1]} P={points.shape[1] // 3} "
                      f"k={k} live={live} ({live / m:.1f} a query) "
                      f"found={chk['found']}",
             "digest": digest(k12.knn_search(*args)),
             "bound_ms": b_ms, "bound_by": b_by}
        r.update(times(lambda: k12.knn_search(*args)))
        for d in variants:
            want = k12.knn_search_plain(*args)
            got = k12.launch(*args, defines=d)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{d}: kernel != plain on {tag}")
            r[d[0]] = dict(times(lambda: k12.launch(*args, defines=d)),
                           digest=digest(got))
        # the selection alone, on the plain version's prebuilt keys
        p = points.shape[1] // 3
        rows = points[slots.long()]
        dx = rows[..., :p] - q[:, None, 0:1]
        dy = rows[..., p:2 * p] - q[:, None, 1:2]
        dz = rows[..., 2 * p:] - q[:, None, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        live_mask = (torch.arange(p, device=dev)[None, None, :]
                     < cnt[..., None])
        ok = (live_mask & (d2 <= k12.radius_sq(radius))).reshape(m, -1)
        d2m = torch.where(ok, d2.reshape(m, -1), float("inf"))
        flat = torch.arange(d2m.shape[1], dtype=torch.int64, device=dev)
        key = (d2m.view(torch.int32).to(torch.int64) << 32) | flat
        topk = times(lambda: torch.topk(key, k, dim=1, largest=False,
                                        sorted=True))
        r["topk_on_prebuilt_keys"] = topk
    out["inputs"][tag] = r
print(json.dumps(out))
'''


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__.splitlines()[3].strip(), file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[2]
    other = Path(args[0]).resolve()
    inputs = here / "build" / "exp_select_inputs.pt"
    inputs.parent.mkdir(parents=True, exist_ok=True)
    if not inputs.exists():
        run_child(_MAKE, here, str(inputs))
    cfg = json.dumps({"inputs": str(inputs)})
    runs = []
    for name, root in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        res = run_child(_CHILD, root, cfg)
        res["which"] = name
        print(json.dumps(res), flush=True)
        runs.append(res)
    keys = ("ms", "warm_ms", "host_ms")
    summary = {
        f"{r['which']} {i}": {
            tag: {**{k: rec[k] for k in keys}, "digest": rec["digest"],
                  **{v: {k: rec[v][k] for k in keys}
                     for v in ("K12_SPLIT=1", "K12_SPLIT=2", "K12_SPLIT=4")
                     if v in rec}}
            for tag, rec in r["inputs"].items()}
        for i, r in enumerate(runs)}
    same = all(runs[0]["inputs"][t]["digest"] == r["inputs"][t]["digest"]
               for r in runs for t in runs[0]["inputs"])
    print(json.dumps({"card": card_line(), "same_digests": same,
                      "summary": summary}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
