#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ct_icp_torch) on one NVIDIA GPU.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

It needs one CUDA device and nvcc, and exits non-zero without a result line
when either is missing. Phases; any failure raises and exits non-zero:

  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. build the CUDA kernels K1-K3 from ct_icp_torch/csrc with nvcc (one
     process per source, all started together); print the build time and
     ptxas's register / shared-memory lines;
  3. each kernel against its plain PyTorch version on the card at the
     driving profile's shapes (tolerances: ct_icp_torch/kernels/checks.py),
     then the kernel's, the plain version's and, for K1, the library
     gather's time by CUDA events; the stages that stay plain torch in this
     slice (ROADMAP B6, B9-B11) timed the same way, each with its bound;
  4. the main path: Odometry(default_driving_profile(), device="cuda") over
     the 80-frame synthetic corridor, seed 3, stream_frames(batch=16):
     median per-batch frames/s, failures, mean APE (against the 0.07 m gate
     of the 3-seed benchmark; this run asserts <= 0.10 m on one seed), map
     points, and each kernel's launches in that run (counts set to 0 just
     before it);
  5. one JSON line of the kernels, the card's line, and the result line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ct_icp_torch.config.options import default_driving_profile
from ct_icp_torch.datasets import corridor as cor
from ct_icp_torch.icp import solver as slv
from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import candidate_gather as k1
from ct_icp_torch.kernels import checks
from ct_icp_torch.kernels import map_insert as k3
from ct_icp_torch.kernels import plane_moments as k2
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.odometry import pipeline as pl
from ct_icp_torch.odometry.odometry import PRUNE_PERIOD, Odometry
from ct_icp_torch.ops import voxel as vx

NUM_FRAMES = 80
SEED = cor.APE_SEEDS[0]
BATCH = 16
APE_SMOKE_BOUND_M = 0.10
K1_QUERIES = 1536

# One H100 SXM (NVIDIA data sheet, full 700 W power limit): HBM rate and
# the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KERNELS = {
    "candidate_gather": dict(
        module=k1, source="ct_icp_torch/csrc/candidate_gather.cu",
        replaces="ct_icp_tpu/mapping/voxel_map.py:668"),
    "plane_moments": dict(
        module=k2, source="ct_icp_torch/csrc/plane_moments.cu",
        replaces="ct_icp_tpu/mapping/voxel_map.py:752"),
    "map_insert": dict(
        module=k3, source="ct_icp_torch/csrc/map_insert.cu",
        replaces="ct_icp_tpu/mapping/voxel_map.py:366"),
}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the float32 operations over the card's float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_stateless(fn, reps=50, graph_calls=20, graph=True):
    """Mean ms of one ``fn()`` call on the card. Tries a CUDA graph of
    ``graph_calls`` calls (device time, no host launch overhead); where the
    call cannot be captured, or ``graph`` is False (a call that reads the
    device from the host), back-to-back calls between two events.
    Returns (ms, method)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        if not graph:
            raise RuntimeError("the call reads the device from the host")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(graph_calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        replays = max(reps // graph_calls, 2)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * graph_calls), "cuda-graph"
    except RuntimeError as err:
        torch.cuda.synchronize()
        log(f"  (no graph capture: {str(err).splitlines()[0][:100]})")
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, "events"


def time_mutating(setup, fn, reps=20):
    """Mean ms of ``fn(setup())`` between two events, ``setup()`` (a fresh
    copy of the state the call updates) outside the timed span."""
    for _ in range(2):
        fn(setup())
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        state = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(state)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, "events"


def phase_build():
    names = list(KERNELS)
    t0 = time.time()
    build.build_all(names)
    log(f"build: {len(names)} kernels in {time.time() - t0:.2f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name in names:
        info = build.build_info.get(name)
        if info is None:
            log(f"  {name}: library already built")
            continue
        log(f"  {name}: {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log("   ", line.strip())


def _level_copy(level):
    return vm.MapLevel(*(t.clone() for t in level))


def _warm_level(dev, res, prep):
    """A driving-size level (C = 2^18, P = 30) holding corridor frame
    ``prep``'s points, inserted by the kernel."""
    level = vm.make_level(res.capacity_log2, res.max_num_points, dev)
    pts = torch.as_tensor(prep["xyz"], dtype=torch.float32, device=dev)
    vm.insert_points(level, pts, torch.ones(pts.shape[0], dtype=torch.bool,
                                            device=dev),
                     res.resolution, res.min_distance_between_points, 12)
    torch.cuda.synchronize()
    return level


def phase_stages(dev, odo, preps_by_fid):
    """The main path's device stages that stay plain torch in this slice
    (ROADMAP B6, B9-B11), timed on the card at driving shapes, each with
    its bound. Returns {stage: record}."""
    o = odo.options
    res = o.map_options.resolutions[0]
    reg = odo.registration
    statics = reg.statics
    level = _warm_level(dev, res, preps_by_fid[0])
    prep = preps_by_fid[max(preps_by_fid)]         # a cruise frame
    n = prep["n"]
    out = {}

    # B11: unpack_scan + transform_points of the frame's uploaded scan
    scan = torch.from_numpy(prep["scan_host"].view(np.int16)).to(dev)
    qb = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    tb = torch.zeros(3, device=dev)
    qe = torch.tensor([0.99995, 0.0, 0.0, 0.01], device=dev)
    te = torch.tensor([1.0, 0.02, 0.0], device=dev)

    def b11():
        raw, alphas = pl.unpack_scan(scan)
        return pl.transform_points(raw[:n], alphas[:n], qb, tb, qe, te)

    ms, how = time_stateless(b11)
    rows = scan.shape[0]
    out["B11 unpack_scan+transform_points"] = dict(
        ms=ms, timing=how, bytes=rows * (8 + 16) + n * (16 + 12),
        ops=n * 60.0, shape=f"R={rows} n={n}")

    # B9: compact_mask of an insert-size mask (the plain K3 version's use)
    mask = torch.from_numpy(np.random.default_rng(SEED).uniform(size=n)
                            < 0.3).to(dev)
    ms, how = time_stateless(lambda: vx.compact_mask(mask, n))
    out["B9 compact_mask"] = dict(ms=ms, timing=how, bytes=n * (1 + 4),
                                  ops=0.0, shape=f"N={n}")

    # B10: prune_level over all C slots (updates the level in place)
    loc = torch.tensor([5.0, 0.0, 0.0], device=dev)
    ms, how = time_mutating(lambda: _level_copy(level),
                            lambda lv: vm.prune_level(lv, loc, 10.0))
    c = level.capacity
    out["B10 prune_level"] = dict(ms=ms, timing=how, bytes=c * (24 + 12),
                                  ops=c * 9.0, shape=f"C={c}")

    # B6: one LM inner loop (ls_max_num_iters steps) at the decimated
    # keypoint count, against the warm level
    dyn = slv.unpack_dynamics(reg.dynamics(odo._effective_icp_options(
        prep["info"])))
    kp = prep["kp_n"]
    keep = pl.decimation_indices(kp, dyn.max_num_residuals)
    sel = np.arange(kp) if keep is None else keep
    raw = torch.as_tensor(prep["xyz"][sel], dtype=torch.float32, device=dev)
    alphas = torch.as_tensor(prep["alphas"][sel], dtype=torch.float32,
                             device=dev)
    valid = torch.ones(raw.shape[0], dtype=torch.bool, device=dev)
    anchors, normals, geom_w, ok, _ = slv._build_problem(
        statics, dyn, level, raw, alphas, valid, qb, tb, qb, tb, None, True)
    prior = torch.cat([qb, tb, tb, torch.as_tensor(odo._betas(),
                                                   device=dev)])
    steps = slv._lm_inner_loop(statics, dyn, raw, alphas, anchors, normals,
                               geom_w, ok, qb, tb, qb, tb, prior)[-1]
    ms, how = time_stateless(
        lambda: slv._lm_inner_loop(statics, dyn, raw, alphas, anchors,
                                   normals, geom_w, ok, qb, tb, qb, tb,
                                   prior), reps=20, graph=False)
    k = raw.shape[0]
    # per keypoint and step: the residual and its 12 forward-mode tangents
    # through slerp (~80 flops each), J^T W J and J^T W r (~180), two trial
    # costs (~160); inputs raw, alpha, anchor, normal, weight, mask
    out["B6 LM inner loop"] = dict(
        ms=ms, timing=how, bytes=k * 45.0 * steps,
        ops=k * (13 * 80 + 180 + 160) * float(steps),
        shape=f"K={k} steps={steps}")
    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"])
        log(f"{name} ({r['shape']}): {r['ms']:.4f} ms ({r['timing']}), "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    del level
    torch.cuda.empty_cache()
    return out


def phase_kernels(dev, o, preps_by_fid):
    """Each kernel against its plain version at driving shapes (options
    ``o``, scans of ``preps_by_fid``), then times. Returns {name: partial
    kernel record}."""
    res = o.map_options.resolutions[0]
    icp = o.ct_icp_options
    nv = 1
    radius = float(o.map_options.default_radius)
    k_nearest = icp.max_number_neighbors
    records = {}

    level = _warm_level(dev, res, preps_by_fid[0])
    log(f"map: C={level.capacity} P={level.max_points} "
        f"points={int(level.num_points[0])} from frame 0 "
        f"({preps_by_fid[0]['n']} points)")

    # ---- K1: M keypoints of frame 1 x 27 voxels
    p1 = preps_by_fid[1]
    q = torch.as_tensor(p1["xyz"][:K1_QUERIES], dtype=torch.float32,
                        device=dev)
    m = q.shape[0]
    qv = torch.ones(m, dtype=torch.bool, device=dev)
    thr = icp.threshold_voxel_occupancy
    err = checks.check_candidate_gather(level, q, qv, res.resolution, nv, thr)
    args = (level.keys, level.count, level.points, q, qv, res.resolution, nv,
            thr)
    ms, how = time_stateless(lambda: k1.candidate_gather(*args))
    plain_ms, _ = time_stateless(lambda: k1.candidate_gather_plain(*args))
    cand = (vx.voxel_coords(q, res.resolution)[:, None, :]
            + k1.neighbor_offsets(nv, dev)[None])
    slots, _ = k1.find_slots_with_count(level.keys, level.count, cand)
    flat = torch.clamp_min(slots.reshape(-1), 0).contiguous()
    lib_ms, _ = time_stateless(lambda: level.points.index_select(0, flat))
    n_pairs = flat.numel()
    n_vox = torch.unique(vx.voxel_hash_u32(cand.reshape(-1, 3))).numel()
    n_rows = torch.unique(flat).numel()
    row_b = level.points.shape[1] * 4
    k1_bytes = (m * 13 + n_vox * 32 + n_rows * (row_b + 4)
                + n_pairs * (row_b + 4))
    records["candidate_gather"] = dict(
        max_abs_err=err["max_abs_err"], ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bytes=k1_bytes, ops=0.0, timing=how,
        shape=f"M={m} O={n_pairs // m} 3P={level.points.shape[1]} "
              f"C={level.capacity}")
    log(f"K1 candidate_gather M={m}: identical to plain; {ms:.4f} ms "
        f"({how}), plain {plain_ms:.4f} ms, index_select {lib_ms:.4f} ms")

    # ---- K2: the same rows, queries moved as an ICP iteration moves them
    rows, cnt = k1.candidate_gather(*args)
    q2 = q + 0.02
    err_f = checks.check_plane_moments(rows, cnt, q2, radius, k_nearest)
    fresh = k2.plane_moments_plain(rows, cnt, q2, radius, k_nearest)
    err_c = checks.check_plane_moments(rows, cnt, q, radius, k_nearest,
                                       fresh.r_eff2)
    ms, how = time_stateless(
        lambda: k2.plane_moments(rows, cnt, q2, radius, k_nearest))
    plain_ms, _ = time_stateless(
        lambda: k2.plane_moments_plain(rows, cnt, q2, radius, k_nearest))
    ms_c, _ = time_stateless(
        lambda: k2.plane_moments(rows, cnt, q, radius, k_nearest,
                                 fresh.r_eff2))
    live = float(cnt.sum())
    in_r = float(fresh.count.sum())
    # fresh call: d2 twice (shell histogram + sums, 8 flops each) per live
    # candidate, 15 flops of sums per in-radius one
    k2_bytes = live * 12 + cnt.numel() * 4 + m * 12 + m * 88
    records["plane_moments"] = dict(
        max_abs_err=max(err_f["max_abs_err"], err_c["max_abs_err"]), ms=ms,
        plain_ms=plain_ms, library_ms=None, bytes=k2_bytes,
        ops=live * 16 + in_r * 15, timing=how,
        shape=f"M={m} O={rows.shape[1]} P={rows.shape[2] // 3} "
              f"live={int(live)}", cached_ms=ms_c)
    log(f"K2 plane_moments M={m}: within tolerance (max abs err "
        f"{records['plane_moments']['max_abs_err']:.3g}); fresh {ms:.4f} ms "
        f"({how}), cached-radius {ms_c:.4f} ms, plain {plain_ms:.4f} ms")

    # ---- K3: a startup frame (0.2 m dedup, 12 rounds) and a cruise frame
    # (0.5 m dedup, 4 rounds) into the warm level
    k3_recs = []
    for fid, rounds in ((1, 12), (max(preps_by_fid), 4)):
        prep = preps_by_fid[fid]
        pts = torch.as_tensor(prep["xyz"], dtype=torch.float32, device=dev)
        n = pts.shape[0]
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        md = res.min_distance_between_points
        out = checks.check_map_insert(level, pts, valid, res.resolution, md,
                                      rounds)

        def setup():
            return _level_copy(level)

        ms, how = time_mutating(setup, lambda lv: vm.insert_points(
            lv, pts, valid, res.resolution, md, rounds))
        plain_ms, _ = time_mutating(setup, lambda lv: k3.map_insert_plain(
            *lv[:3], lv.num_points, pts, valid, res.resolution, md, rounds))
        # data-dependent work: the voxels the points land in, read once
        after = _level_copy(level)
        vm.insert_points(after, pts, valid, res.resolution, md, rounds)
        coords = vx.voxel_coords(pts, res.resolution)
        s, _ = k1.find_slots_with_count(after.keys, after.count, coords)
        s = s[s >= 0]
        ec = level.count[s].to(torch.float64)      # counts before the insert
        uniq = torch.unique(s)
        new_keys = int(((level.keys[uniq] == 0) | (level.keys[uniq] == 1))
                       .sum())
        n_bytes = (n * 13 + uniq.numel() * 32
                   + float(level.count[uniq].sum()) * 12 + uniq.numel() * 8
                   + out["inserted"] * 12 + new_keys * 4)
        k3_recs.append(dict(ms=ms, plain_ms=plain_ms, bytes=n_bytes,
                            ops=float(ec.sum()) * 8, timing=how,
                            max_abs_err=out["max_abs_err"],
                            shape=f"N={n} rounds={rounds}"))
        log(f"K3 map_insert N={n} max_rounds={rounds}: identical to plain "
            f"({out['inserted']} inserted); {ms:.4f} ms ({how}), plain "
            f"{plain_ms:.4f} ms")
    # the line reports the startup frame (the larger insert); both are logged
    rec = dict(k3_recs[0])
    rec["library_ms"] = None
    rec["cruise"] = k3_recs[1]
    records["map_insert"] = rec
    del level, rows, cnt
    torch.cuda.empty_cache()
    return records


def phase_main_path(odo, frames, preps):
    """The driving slice through the user's entry points: ``preps`` are
    ``odo.prepare_frame`` of ``frames``."""
    for name in KERNELS:
        KERNELS[name]["module"].launches = 0
    torch.cuda.synchronize()
    batch_s = []
    failures = 0
    outer_iters = 0
    t_batch = time.time()
    t0 = t_batch
    for i, summary in enumerate(odo.stream_frames(iter(preps), batch=BATCH)):
        outer_iters += summary.icp_summary.num_iters
        if not summary.success:
            failures += 1
        if (i + 1) % BATCH == 0 or i + 1 == len(preps):
            torch.cuda.synchronize()
            now = time.time()
            batch_s.append((now - t_batch, (i % BATCH) + 1))
            t_batch = now
    wall = time.time() - t0
    launches = {name: KERNELS[name]["module"].launches for name in KERNELS}
    errs = cor.seq_ape(odo, frames)
    fps_batches = [n / s for s, n in batch_s]
    out = dict(frames=len(preps), batch=BATCH, failures=failures,
               mean_ape_m=float(np.mean(errs)), final_drift_m=float(errs[-1]),
               map_points=odo.map_size(),
               median_batch_fps=float(np.median(fps_batches)),
               batch_fps=fps_batches, wall_s=wall,
               host_syncs=odo.host_syncs,
               host_syncs_per_frame=odo.host_syncs / len(preps),
               # each outer ICP iteration and each LM step reads the device
               # once (solver.py), so the syncs split into the two
               icp_iters_per_frame=outer_iters / len(preps),
               lm_steps_per_frame=(odo.host_syncs - outer_iters) / len(preps),
               prunes_per_frame=sum(
                   p["info"].registered_fid % PRUNE_PERIOD == 0
                   for p in preps) / len(preps),
               launches=launches)
    log("main path: " + json.dumps(out))
    log(f"  mean APE {out['mean_ape_m']:.4f} m (smoke bound "
        f"{APE_SMOKE_BOUND_M} m; the 3-seed gate is {cor.APE_BOUND_M} m)")
    if failures:
        raise RuntimeError(f"main path: {failures} failed frames")
    if not out["mean_ape_m"] <= APE_SMOKE_BOUND_M:
        raise RuntimeError(f"main path: mean APE {out['mean_ape_m']} m > "
                           f"{APE_SMOKE_BOUND_M} m")
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise RuntimeError(f"the main path never launched {missing}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    phase_build()

    t0 = time.time()
    scene = cor.build_scene()
    traj = cor.straight_trajectory(400, NUM_FRAMES * 0.1 + 0.5)
    frames = cor.render_corridor(scene, traj, NUM_FRAMES, SEED)
    odo = Odometry(default_driving_profile(), device=dev)
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
             for i, f in enumerate(frames)]
    log(f"corridor: {len(frames)} frames rendered and prepared in "
        f"{time.time() - t0:.1f} s; points after dedup "
        f"{[p['n'] for p in preps[:2]]} ... {preps[-1]['n']}, keypoints "
        f"{[p['kp_n'] for p in preps[:2]]} ... {preps[-1]['kp_n']}")

    by_fid = {0: preps[0], 1: preps[1], len(preps) - 1: preps[-1]}
    records = phase_kernels(dev, odo.options, by_fid)
    stages = phase_stages(dev, odo, by_fid)
    main_out = phase_main_path(odo, frames, preps)
    per_frame = {"B11 unpack_scan+transform_points": 1.0,
                 "B9 compact_mask": 0.0,
                 "B10 prune_level": main_out["prunes_per_frame"],
                 "B6 LM inner loop": main_out["icp_iters_per_frame"]}
    for name, r in stages.items():
        r["calls_per_frame"] = per_frame[name]

    kernels = []
    for name, spec in KERNELS.items():
        r = records[name]
        b_ms, b_by = bound(r["bytes"], r["ops"])
        kernels.append(dict(
            name=name, route="cuda", source=spec["source"],
            replaces=spec["replaces"], launches=main_out["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=r["library_ms"],
            timing=r["timing"], shape=r["shape"]))
    log(f"cruise-frame insert: {json.dumps(records['map_insert']['cruise'])}")
    log(f"plane_moments with the cached radius: "
        f"{records['plane_moments']['cached_ms']} ms")
    log("stages: " + json.dumps(stages))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
