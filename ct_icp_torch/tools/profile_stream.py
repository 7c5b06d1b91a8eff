"""Where the time of the streamed driving slice goes, on the card.

    python3 -m ct_icp_torch.tools.profile_stream [--frames 48] [--batch 16]

Runs ``Odometry(default_driving_profile())`` over the synthetic corridor
(seed 3) with ``stream_frames(batch)`` and profiles the last batch with
``torch.profiler`` (CPU and CUDA activities). The solver's and the map's
stages are labelled with ``record_function`` ranges for the run (the
package itself carries no instrumentation). Prints one JSON line: the
batch's wall time under the profiler, the device's busy share (device
time over wall time), device operations per frame, the heaviest host
ops and device work, and for each stage its calls, its host time and the
device time of the torch ops it ran (the kernels launched through ctypes
are not attributed to a range; chip_smoke.py times those).
"""

import argparse
import collections
import functools
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from ct_icp_torch.config.options import default_driving_profile
from ct_icp_torch.datasets import corridor as cor
from ct_icp_torch.icp import solver as slv
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.odometry import pipeline as pl
from ct_icp_torch.odometry.odometry import Odometry

# (module, attribute, label): the stages of one frame
STAGES = (
    (pl, "unpack_scan", "B11 unpack_scan"),
    (slv, "_build_problem", "K1+K2 association (build_problem)"),
    (slv, "_lm_inner_loop", "B6 LM inner loop"),
    (pl, "transform_points", "B11 transform_points"),
    (vm, "prune_level", "B10 prune_level"),
    (vm, "insert_points", "K3 insert_points"),
)


def _labelled(fn, label):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_stream: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    for mod, attr, label in STAGES:
        setattr(mod, attr, _labelled(getattr(mod, attr), label))

    scene = cor.build_scene()
    traj = cor.straight_trajectory(400, args.frames * 0.1 + 0.5)
    frames = cor.render_corridor(scene, traj, args.frames, cor.APE_SEEDS[0])
    odo = Odometry(default_driving_profile())
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
             for i, f in enumerate(frames)]
    head, last = preps[:-args.batch], preps[-args.batch:]
    for _ in odo.stream_frames(iter(head), batch=args.batch):
        pass
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        summaries = list(odo.stream_frames(iter(last), batch=args.batch))
        torch.cuda.synchronize()
        wall = time.time() - t0
    labels = {label for _, _, label in STAGES}
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
    for _, _, label in STAGES:
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
        card=card, frames=len(last), batch=args.batch,
        first_frame=last[0]["info"].registered_fid,
        wall_ms_per_frame=wall * 1e3 / len(last),
        device_busy_ms_per_frame=busy_us / 1e3 / len(last),
        device_busy_share=busy_us / 1e6 / wall,
        device_ops_per_frame=len(device) / len(last),
        failures=sum(not s.success for s in summaries),
        host_syncs_per_frame=odo.host_syncs / len(preps),
        stages=stages,
        top_ops_by_host_self_ms_per_frame={
            e.key: e.self_cpu_time_total / 1e3 / len(last) for e in top},
        top_device_work_ms_per_frame={
            k[:80]: v / 1e3 / len(last) for k, v in by_name.most_common(12)},
        mean_ape_m=float(np.mean(cor.seq_ape(odo, frames))))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
