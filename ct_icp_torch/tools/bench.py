"""The reference's accuracy gates (``bench.py``), run by the port on the card.

    python -m ct_icp_torch.tools.bench --driving [N]
    python -m ct_icp_torch.tools.bench --robust [N]
    python -m ct_icp_torch.tools.bench --escalation [N]
    python -m ct_icp_torch.tools.bench --long [N]
    python -m ct_icp_torch.tools.bench --indoor [N]
    python -m ct_icp_torch.tools.bench --backend [N]
    python -m ct_icp_torch.tools.bench --replay [N]
    python -m ct_icp_torch.tools.bench --backend-robust [N]

``N`` cuts the frames (default: the gate's own count). Each gate prints one
JSON line and exits 1 when its accuracy bound fails:
  * ``--driving``: the 80-frame corridor, ``default_driving_profile()``,
    batch 16; mean APE over seeds 3, 4, 5 <= 0.07 m and 0 failures;
  * ``--robust``: the corridor at 8 m/s, ``robust_driving_profile()``,
    batch 8; mean APE over seeds 3, 4, 5 <= 0.058 m;
  * ``--escalation``: the yaw jolt and speed surge (48 frames, 3 attempts,
    batch 8), the reference's five conditions;
  * ``--long``: the 500-frame urban drive, ``default_driving_profile()``,
    batch 16; segment RPE over seeds 7, 8, 9 <= 0.50 %Tr and 0 failures.
    The timed seed's frames are rendered beforehand, as the reference does;
  * ``--indoor``: the 240-frame handheld indoor walk,
    ``default_robust_outdoor_low_inertia()`` (three map levels), batch 4;
    INDOOR segment RPE over seeds 7, 8, 9 <= 1.3 %Tr, mean APE <= 0.10 m
    and 0 failures; the timed seed rendered beforehand, as for ``--long``;
  * ``--backend``: the long drive's first 320 frames (seed 7), batch 16,
    ``default_driving_profile()`` with the CT-BA backend on (window 8,
    period 8): <= 0.42 %Tr, 0 failures and at least one refinement (the
    reference's ``run_backend``). It prints the refinements, the median
    host ms of a refine and frames/s, and streams the same rendered frames
    again with the backend off in the same process, so that both rates
    come from one card and one host;
  * ``--replay``: the reference's replay test (tests/test_ct_ba.py:182-224,
    ``datasets/room.py``): the room, seed 47, 5 mm noise, 15 frames per
    frame (``register_frame``), the test's front end degraded to 2 ICP
    iterations of 1 LM step at the default profile's capacities, the
    backend on (window 6, period 3, 2 steps, replay) against off: mean
    relative APE on < 0.8 x off, at least 2 refinements, 0 failures. It
    prints the replays, the points each evicted and re-inserted, their
    host ms and host syncs a frame;
  * ``--backend-robust``: the robust gate's corridor (80 frames, 8 m/s,
    seeds 3, 4, 5, batch 8) through ``robust_driving_profile()`` with the
    backend on: mean APE <= 0.058 m (the robust gate's bound), 0 failures,
    at least one refinement on every seed, and one callback for each
    committed frame.
Frames/s is the median per-batch rate after two warm-up batches on the
timed seed (the first), measured on the card and reported beside the
card's name and power limit; the reference's frames/s floors are TPU
figures and gate nothing here. Frames are prepared in a PrefetchIterator
(3 workers). Needs one CUDA device: exits 2 without one.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ct_icp_torch.config.options import (default_driving_profile,
                                         default_robust_outdoor_low_inertia,
                                         robust_driving_profile)
from ct_icp_torch.datasets import corridor as cor
from ct_icp_torch.datasets import indoor_walk as iw
from ct_icp_torch.datasets import long_drive as ld
from ct_icp_torch.datasets import room
from ct_icp_torch.datasets.streaming import (CachedAcquisition,
                                             stream_acquisition)
from ct_icp_torch.odometry.concurrent import PrefetchIterator
from ct_icp_torch.odometry.odometry import Odometry

DRIVING_BATCH = 16
ROBUST_BATCH = 8
# the backend gate (reference bench.py:864-867): the port's own copies
BACKEND_TR_BOUND_PCT = 0.42
BACKEND_FRAMES = 320
BACKEND_SEED = 7
BACKEND_BATCH = 16


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else torch.cuda.get_device_name(0)


def _stream(opts, frames, batch, callbacks=None):
    """Stream ``frames`` through a new Odometry(opts) on the card, prepared
    in prefetch workers; a list given as ``callbacks`` gets the frame index
    of every FINISHED_REGISTRATION callback. Returns (odo, summaries,
    median per-batch frames/s after two warm-up batches or None)."""
    odo = Odometry(opts, device="cuda")
    if callbacks is not None:
        odo.register_callback(
            Odometry.FINISHED_REGISTRATION,
            lambda o, s, kp: callbacks.append(len(o.trajectory) - 1) or True)

    def prepare(item):
        i, fr = item
        return odo.prepare_frame(fr["xyz"], fr["timestamps"], i, frame_id=i)

    summaries, ends = [], []
    with PrefetchIterator(enumerate(frames), prepare,
                          depth=2 * batch) as preps:
        for i, s in enumerate(odo.stream_frames(preps, batch=batch)):
            summaries.append(s)
            if (i + 1) % batch == 0 and i + 1 >= 2 * batch:
                torch.cuda.synchronize()
                ends.append(time.time())
    fps = [batch / d for d in np.diff(ends)]
    return odo, summaries, (float(np.median(fps)) if fps else None)


def _corridor_gate(name, opts, traj, num_frames, batch, bound):
    scene = cor.build_scene()
    apes, failures, fps, attempts = [], 0, None, []
    for seed in cor.APE_SEEDS:
        frames = cor.render_corridor(scene, traj, num_frames, seed)
        odo, summaries, f = _stream(opts, frames, batch)
        if seed == cor.APE_SEEDS[0]:    # the timed seed
            fps = f
        apes.append(float(np.mean(cor.seq_ape(odo, frames))))
        failures += sum(not s.success for s in summaries)
        attempts += [s.number_of_attempts for s in summaries]
    ape = float(np.mean(apes))
    return {
        "metric": f"synthetic_{name}_odometry", "frames": num_frames,
        "batch": batch, "failures": failures, "mean_ape_m": ape,
        "ape_per_seed": apes, "ape_bound_m": bound,
        "mean_attempts": float(np.mean(attempts)),
        "frames_per_sec": fps,
        "accuracy_ok": bool(ape <= bound and failures == 0)}


def run_driving(num_frames=None):
    n = num_frames or 80
    return _corridor_gate("driving", default_driving_profile(),
                          cor.straight_trajectory(400, n * 0.1 + 0.5), n,
                          DRIVING_BATCH, cor.APE_BOUND_M)


def run_robust(num_frames=None):
    n = num_frames or 80
    return _corridor_gate("robust", robust_driving_profile(),
                          cor.robust_corridor_trajectory(n), n, ROBUST_BATCH,
                          cor.ROBUST_APE_BOUND_M)


def run_escalation(num_frames=None):
    n = num_frames or 48
    b0, b1 = cor.ESC_BURST
    s0, s1 = cor.ESC_SURGE
    surge = n >= s1
    frames = cor.render_corridor(cor.build_scene(),
                                 cor.escalation_trajectory(n), n,
                                 cor.APE_SEEDS[0])
    opts = dataclasses.replace(robust_driving_profile(), robust_num_attempts=3)
    t0 = time.time()
    odo, summaries, _ = _stream(opts, frames, ROBUST_BATCH)
    wall = time.time() - t0
    errs = cor.seq_ape(odo, frames)
    attempts = [s.number_of_attempts for s in summaries]
    levels = [s.robust_level for s in summaries]
    post = errs[b1 + 4:(s0 - 1 if surge else len(errs))]
    burst_attempts = float(np.mean(attempts[b0:b1]))
    burst_level = float(np.mean(levels[b0:b1]))
    post_ape = float(np.mean(post)) if post else float("inf")
    exhausted = [i for i, a in enumerate(attempts)
                 if a >= opts.robust_num_attempts]
    surge_ok = (not surge or (
        len(exhausted) >= cor.ESC_MIN_EXHAUSTED_FRAMES
        and all(i >= s0 - 1 for i in exhausted)
        and max(levels) >= cor.ESC_MIN_GAP_LEVEL))
    return {
        "metric": "synthetic_robust_escalation_recovery", "frames": len(errs),
        "failures": sum(not s.success for s in summaries),
        "post_burst_ape_m": post_ape,
        "mean_burst_attempts": burst_attempts,
        "mean_burst_level": burst_level, "max_attempts": max(attempts),
        "max_level": max(levels), "exhausted_frames": exhausted,
        "mean_ape_m": float(np.mean(errs)),
        "wall_sec_per_frame": wall / max(len(errs), 1),
        "accuracy_ok": bool(burst_attempts >= cor.ESC_MIN_BURST_ATTEMPTS
                            and burst_level >= cor.ESC_MIN_BURST_LEVEL
                            and post_ape <= cor.ESC_POST_APE_BOUND_M
                            and surge_ok)}


def run_long(num_frames=None):
    n = num_frames or ld.LONG_FRAMES
    runs = []
    for seed in ld.LONG_SEEDS:
        odo = Odometry(default_driving_profile(), device="cuda")
        runs.append(stream_acquisition(
            odo, ld.load_acquisition(seed), n, ld.LONG_BATCH,
            prerender=seed == ld.LONG_SEEDS[0]))
    tr = float(np.mean([r["tr_pct"] for r in runs]))
    failures = sum(r["failures"] for r in runs)
    first = runs[0]
    return {
        "metric": "synthetic_long_drive_segment_rpe", "value": tr,
        "unit": "%Tr", "frames": first["frames"], "batch": ld.LONG_BATCH,
        "failures": failures, "tr_per_seed": [r["tr_pct"] for r in runs],
        "ape_per_seed": [r["mean_ape_m"] for r in runs],
        "mean_ape_m": float(np.mean([r["mean_ape_m"] for r in runs])),
        "segments": first["segments"],
        "frames_per_sec": first["median_batch_fps"],
        "render_s": first["render_s"], "stream_s": first["stream_s"],
        "host_syncs_per_frame": first["host_syncs_per_frame"],
        "rebases": [r["rebases"] for r in runs],
        "tr_bound_pct": ld.LONG_TR_BOUND_PCT,
        "accuracy_ok": bool(tr <= ld.LONG_TR_BOUND_PCT and failures == 0)}


def run_indoor(num_frames=None):
    n = num_frames or iw.INDOOR_FRAMES
    runs = []
    for seed in iw.INDOOR_SEEDS:
        odo = Odometry(default_robust_outdoor_low_inertia(), device="cuda")
        runs.append(stream_acquisition(
            odo, iw.load_acquisition(seed), n, iw.INDOOR_BATCH,
            prerender=seed == iw.INDOOR_SEEDS[0], driving=False))
    tr = float(np.mean([r["tr_pct"] for r in runs]))
    ape = float(np.mean([r["mean_ape_m"] for r in runs]))
    failures = sum(r["failures"] for r in runs)
    first = runs[0]
    return {
        "metric": "synthetic_indoor_low_inertia_segment_rpe", "value": tr,
        "unit": "%Tr_indoor", "frames": first["frames"],
        "batch": iw.INDOOR_BATCH, "failures": failures,
        "tr_per_seed": [r["tr_pct"] for r in runs],
        "mean_ape_m": ape, "ape_per_seed": [r["mean_ape_m"] for r in runs],
        "mean_attempts": first["mean_attempts"],
        "segments": first["segments"],
        "frames_per_sec": first["median_batch_fps"],
        "render_s": first["render_s"], "stream_s": first["stream_s"],
        "host_syncs_per_frame": first["host_syncs_per_frame"],
        "map_points": first["map_points"],
        "tr_bound_pct": iw.INDOOR_TR_BOUND_PCT,
        "ape_bound_m": iw.INDOOR_APE_BOUND_M,
        "accuracy_ok": bool(tr <= iw.INDOOR_TR_BOUND_PCT
                            and ape <= iw.INDOOR_APE_BOUND_M
                            and failures == 0)}


def backend_profile(enabled: bool = True):
    """``default_driving_profile()`` with the CT-BA backend on (or off)."""
    o = default_driving_profile()
    return dataclasses.replace(o, backend=dataclasses.replace(
        o.backend, enabled=enabled))


def run_backend(num_frames=None):
    n = num_frames or BACKEND_FRAMES
    acq = CachedAcquisition(ld.load_acquisition(BACKEND_SEED))
    runs = {}
    for name, on in (("on", True), ("off", False)):
        odo = Odometry(backend_profile(on), device="cuda")
        runs[name] = stream_acquisition(odo, acq, n, BACKEND_BATCH)
        if on:
            b = odo.backend
            runs[name].update(
                refinements=b.refinements, refine_ms=list(b.refine_ms),
                event_waits_per_frame=b.event_waits / runs[name]["frames"])
    on, off = runs["on"], runs["off"]
    return {
        "metric": "synthetic_backend_long_drive_segment_rpe",
        "value": on["tr_pct"], "unit": "%Tr", "frames": on["frames"],
        "batch": BACKEND_BATCH, "seed": BACKEND_SEED,
        "failures": on["failures"], "refinements": on["refinements"],
        "refine_ms_median": float(np.median(on["refine_ms"]))
        if on["refine_ms"] else None,
        "mean_ape_m": on["mean_ape_m"],
        "frames_per_sec": on["median_batch_fps"],
        "frames_per_sec_backend_off": off["median_batch_fps"],
        "tr_pct_backend_off": off["tr_pct"],
        "host_syncs_per_frame": on["host_syncs_per_frame"],
        "host_syncs_per_frame_backend_off": off["host_syncs_per_frame"],
        "event_waits_per_frame": on["event_waits_per_frame"],
        "render_s": on["render_s"], "stream_s": on["stream_s"],
        "stream_s_backend_off": off["stream_s"],
        "tr_bound_pct": BACKEND_TR_BOUND_PCT,
        "accuracy_ok": bool(on["tr_pct"] <= BACKEND_TR_BOUND_PCT
                            and on["failures"] == 0
                            and on["refinements"] > 0)}


def run_room(opts, acq, num_frames, setup=None):
    """The room's frames ``acq`` through ``register_frame`` of a new
    Odometry(opts) on the card (given to ``setup`` first, when given):
    failures, mean relative APE, refinements, the replays' records, host
    syncs a frame and frames/s (synchronized at the end). Returns (odo,
    that record)."""
    odo = Odometry(opts, device="cuda")
    if setup is not None:
        setup(odo)
    frames = [acq.frame(i) for i in range(num_frames)]
    gt, summaries = [], []
    torch.cuda.synchronize()
    t0 = time.time()
    for i, fr in enumerate(frames):
        summaries.append(odo.register_frame(fr["xyz"], fr["timestamps"],
                                            frame_id=i))
        gt.append(fr["end_pose"])
    traj = odo.get_trajectory()
    torch.cuda.synchronize()
    wall = time.time() - t0
    b = odo.backend
    return odo, {
        "frames": num_frames,
        "failures": sum(not s.success for s in summaries),
        "mean_ape_m": room.relative_ape(traj, gt),
        "refinements": b.refinements if b is not None else 0,
        "replays": len(odo.replay_stats),
        "replayed_frames": [r["frames"] for r in odo.replay_stats],
        "replay_inserted": [r["inserted"] for r in odo.replay_stats],
        "replay_evicted": [r["evicted"] for r in odo.replay_stats],
        "replay_host_ms": [r["host_ms"] for r in odo.replay_stats],
        "refine_host_ms": list(b.refine_ms) if b is not None else [],
        "host_syncs_per_frame": odo.host_syncs / num_frames,
        "frames_per_sec": num_frames / wall,
        "map_points": [int(lv.num_points[0]) for lv in odo.map_state]}


def run_replay(num_frames=None):
    n = num_frames or room.REPLAY_FRAMES
    runs = {}
    for name, on in (("off", False), ("on", True)):
        acq = room.make_acquisition(seed=room.REPLAY_SEED,
                                    noise=room.REPLAY_NOISE)
        _, runs[name] = run_room(room.replay_options(on), acq, n)
    on, off = runs["on"], runs["off"]
    bound = room.REPLAY_APE_FACTOR * off["mean_ape_m"]
    return {
        "metric": "synthetic_room_backend_replay_ape",
        "value": on["mean_ape_m"], "unit": "m", "frames": n,
        "seed": room.REPLAY_SEED, "mean_ape_m_backend_off": off["mean_ape_m"],
        "ape_bound_m": bound, "on": on, "off": off,
        "failures": on["failures"] + off["failures"],
        "refinements": on["refinements"],
        "accuracy_ok": bool(on["mean_ape_m"] < bound
                            and on["refinements"]
                            >= room.REPLAY_MIN_REFINEMENTS
                            and on["failures"] == 0
                            and off["failures"] == 0)}


def backend_robust_profile(enabled: bool = True):
    """``robust_driving_profile()`` with the CT-BA backend on (or off)."""
    o = robust_driving_profile()
    return dataclasses.replace(o, backend=dataclasses.replace(
        o.backend, enabled=enabled))


def run_backend_robust(num_frames=None):
    n = num_frames or 80
    scene = cor.build_scene()
    traj = cor.robust_corridor_trajectory(n)
    apes, failures, fps, refinements, callbacks_ok = [], 0, None, [], True
    for seed in cor.APE_SEEDS:
        frames = cor.render_corridor(scene, traj, n, seed)
        fired = []
        odo, summaries, f = _stream(backend_robust_profile(), frames,
                                    ROBUST_BATCH, callbacks=fired)
        if seed == cor.APE_SEEDS[0]:
            fps = f
        apes.append(float(np.mean(cor.seq_ape(odo, frames))))
        failures += sum(not s.success for s in summaries)
        refinements.append(odo.backend.refinements)
        callbacks_ok &= fired == list(range(len(frames)))
    ape = float(np.mean(apes))
    return {
        "metric": "synthetic_robust_backend_odometry", "frames": n,
        "batch": ROBUST_BATCH, "failures": failures, "mean_ape_m": ape,
        "ape_per_seed": apes, "ape_bound_m": cor.ROBUST_APE_BOUND_M,
        "refinements": refinements, "callbacks_per_frame_ok": callbacks_ok,
        "frames_per_sec": fps,
        "accuracy_ok": bool(ape <= cor.ROBUST_APE_BOUND_M and failures == 0
                            and min(refinements) >= 1 and callbacks_ok)}


GATES = {"--driving": run_driving, "--robust": run_robust,
         "--escalation": run_escalation, "--long": run_long,
         "--indoor": run_indoor, "--backend": run_backend,
         "--replay": run_replay, "--backend-robust": run_backend_robust}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args or args[0] not in GATES:
        print(f"usage: python -m ct_icp_torch.tools.bench "
              f"{{{'|'.join(GATES)}}} [frames]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench: needs an NVIDIA GPU (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = GATES[args[0]](int(args[1]) if len(args) > 1 else None)
    result["card"] = _card()
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result), flush=True)
    if not result["accuracy_ok"]:
        print(f"{result['metric']}: ACCURACY GATE FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
