"""Where the time of a streamed slice goes, on the card.

    python3 -m ct_icp_torch.tools.profile_stream [--frames 48] [--batch 16]
    python3 -m ct_icp_torch.tools.profile_stream --robust [--frames 48] \
        [--batch 8]
    python3 -m ct_icp_torch.tools.profile_stream --long [--frames 128]
    python3 -m ct_icp_torch.tools.profile_stream --escalation [--frames 48]
    python3 -m ct_icp_torch.tools.profile_stream --indoor [--frames 36]
    python3 -m ct_icp_torch.tools.profile_stream --knn [--frames 48]

Runs ``Odometry(default_driving_profile())`` over the synthetic corridor
(seed 3), or with ``--robust`` ``Odometry(robust_driving_profile())`` over
the robust gate's 8 m/s corridor, or with ``--escalation`` the robust
profile with 3 attempts over the escalation gate's scene (a yaw jolt over
frames 18-24, a speed surge over 40-48: the profiled last batch is the
surge, whose frames exhaust their attempts), or with ``--long`` the
driving profile
over the first frames of the 500-frame urban drive (seed 7, the rebase
distance at 100 m, so that the batch of frames 112-127 holds the first
rebase), or with ``--indoor`` ``default_robust_outdoor_low_inertia()``
(three map levels) over the first frames of the indoor walk (seed 7,
batch 4: the batch of frames 32-35 lies in the first doorway turn, whose
frames escalate), or with ``--knn`` the driving profile with the exact
k-NN search (``ball_neighborhood=False``: K1 and K17 an ICP iteration)
over the corridor, with ``stream_frames(batch)``, and profiles the last
batch with
``torch.profiler`` (CPU and CUDA activities). The solver's and the map's
stages are labelled with ``record_function`` ranges for the run (the
package itself carries no instrumentation). Prints one JSON line: the
batch's wall time under the profiler, the device's busy share (device
time over wall time), device operations per frame, the heaviest host
ops and device work, and for each stage its calls, its host time and the
device time of the torch ops it ran (the kernels launched through ctypes
are not attributed to a range; chip_smoke.py times those); and, unprofiled,
the median frames/s of the batches before the last but the first.
A stage a tree lacks is left out, so that another tree's package can be
profiled by this script (``tools/exp_stages.py``).
"""

import argparse
import collections
import dataclasses
import functools
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from ct_icp_torch.config.options import (default_driving_profile,
                                         default_robust_outdoor_low_inertia,
                                         robust_driving_profile)
from ct_icp_torch.datasets import corridor as cor
from ct_icp_torch.datasets import indoor_walk as iw
from ct_icp_torch.datasets import long_drive as ld
from ct_icp_torch.icp import solver as slv
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.odometry import pipeline as pl
from ct_icp_torch.odometry.odometry import Odometry

# (module, attribute, label): the stages of one frame
STAGES = (
    (pl, "unpack_scan", "B11 unpack_scan"),
    (slv, "_build_problem", "K1+K2 association (build_problem)"),
    (slv, "_lm_inner_loop", "K5 LM inner loop"),
    (pl, "transform_points", "B11 transform_points"),
    (vm, "prune_level", "B10 prune_level"),
    (vm, "prune_levels", "K15 prune_levels"),
    (vm, "insert_points", "K3 insert_points"),
    (vm, "rebuild_level", "K7+K6 rebuild_level"),
    (pl, "snapshot", "checkpoint snapshot (map clone)"),
)


def _labelled(fn, label):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--robust", action="store_true")
    path.add_argument("--long", action="store_true")
    path.add_argument("--escalation", action="store_true")
    path.add_argument("--indoor", action="store_true")
    path.add_argument("--knn", action="store_true")
    args = ap.parse_args()
    if args.frames is None:
        args.frames = 128 if args.long else 36 if args.indoor else 48
    if args.batch is None:
        args.batch = (8 if args.robust or args.escalation else
                      iw.INDOOR_BATCH if args.indoor else 16)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stream: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    stages_here = [(mod, attr, label) for mod, attr, label in STAGES
                   if hasattr(mod, attr)]
    for mod, attr, label in stages_here:
        setattr(mod, attr, _labelled(getattr(mod, attr), label))

    if args.long or args.indoor:
        acq = (iw.load_acquisition(iw.INDOOR_SEEDS[0]) if args.indoor else
               ld.load_acquisition(ld.LONG_SEEDS[0]))
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            frames = list(pool.map(acq.frame, range(args.frames)))
        if args.indoor:
            odo = Odometry(default_robust_outdoor_low_inertia())
        else:
            odo = Odometry(default_driving_profile())
            odo.rebase_distance = 100.0
    else:
        if args.robust:
            traj = cor.robust_corridor_trajectory(args.frames)
            odo = Odometry(robust_driving_profile())
        elif args.escalation:
            traj = cor.escalation_trajectory(args.frames)
            odo = Odometry(dataclasses.replace(robust_driving_profile(),
                                               robust_num_attempts=3))
        else:
            traj = cor.straight_trajectory(400, args.frames * 0.1 + 0.5)
            o = default_driving_profile()
            if args.knn:
                o = dataclasses.replace(o, ct_icp_options=dataclasses.replace(
                    o.ct_icp_options, ball_neighborhood=False))
            odo = Odometry(o)
        frames = cor.render_corridor(cor.build_scene(), traj, args.frames,
                                     cor.APE_SEEDS[0])
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
             for i, f in enumerate(frames)]
    head, last = preps[:-args.batch], preps[-args.batch:]
    torch.cuda.synchronize()
    batch_s, t_batch = [], time.time()
    for i, _ in enumerate(odo.stream_frames(iter(head), batch=args.batch)):
        if (i + 1) % args.batch == 0:
            torch.cuda.synchronize()
            now = time.time()
            batch_s.append(now - t_batch)
            t_batch = now
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        summaries = list(odo.stream_frames(iter(last), batch=args.batch))
        torch.cuda.synchronize()
        wall = time.time() - t0
    labels = {label for _, _, label in stages_here}
    # device work: kernels, copies and memsets on the card's timeline; the
    # stage ranges appear there too, as annotations spanning their work,
    # and are left out
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.key not in labels]
    busy_us = sum(e.device_time_total for e in device)
    by_name = collections.Counter()
    for e in device:
        by_name[e.key] += e.device_time_total
    stages = {}
    for _, _, label in stages_here:
        spans = [e for e in prof.events()
                 if e.key == label and e.device_type == DeviceType.CPU]
        stages[label] = dict(
            calls_per_frame=len(spans) / len(last),
            host_ms_per_frame=sum(e.cpu_time_total for e in spans)
            / 1e3 / len(last),
            device_ms_per_frame=sum(e.device_time_total for e in spans)
            / 1e3 / len(last))
    host_ops = [e for e in prof.key_averages() if e.key not in labels]
    top = sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:12]
    out = dict(
        card=card, profile=("robust" if args.robust else
                            "escalation" if args.escalation else
                            "long" if args.long else
                            "indoor" if args.indoor else
                            "knn" if args.knn else "driving"),
        frames=len(last), batch=args.batch,
        first_frame=last[0]["info"].registered_fid,
        wall_ms_per_frame=wall * 1e3 / len(last),
        unprofiled_median_batch_fps=(float(np.median(
            [args.batch / t for t in batch_s[1:]])) if len(batch_s) > 1
            else None),
        device_busy_ms_per_frame=busy_us / 1e3 / len(last),
        device_busy_share=busy_us / 1e6 / wall,
        device_ops_per_frame=len(device) / len(last),
        failures=sum(not s.success for s in summaries),
        host_syncs_per_frame=odo.host_syncs / len(preps),
        mean_attempts=float(np.mean([s.number_of_attempts
                                     for s in summaries])),
        speculative_rollbacks=odo.speculative_rollbacks,
        rebases=odo.rebases,
        stages=stages,
        top_ops_by_host_self_ms_per_frame={
            e.key: e.self_cpu_time_total / 1e3 / len(last) for e in top},
        top_device_work_ms_per_frame={
            k[:80]: v / 1e3 / len(last) for k, v in by_name.most_common(12)},
        mean_ape_m=float(np.mean(cor.seq_ape(odo, frames))))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
