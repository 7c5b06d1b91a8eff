"""run_odometry CLI (reference command/cmd_run_odometry.cpp:37-74;
counterpart of ``ct_icp_tpu/cli.py``).

Usage:
    python -m ct_icp_torch.cli -c config.yaml
    python -m ct_icp_torch.cli --profile driving --dataset PLY_DIRECTORY \
        --root-path /data/seq --max-frames 500 [--device cpu]

The odometry runs on the card unless ``--device`` names another torch
device; ``--trace-dir`` records the run with ``torch.profiler`` and writes
a Chrome trace there.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="run_odometry",
        description="CT-ICP LiDAR odometry runner (PyTorch + CUDA)")
    parser.add_argument("-c", "--config", help="Path to the yaml config file")
    parser.add_argument("--profile",
                        choices=["driving", "robust_driving", "robust_outdoor"],
                        default="driving",
                        help="Default options profile when no config is given")
    parser.add_argument("--dataset", default=None,
                        help="Dataset type (KITTI_raw, NCLT, PLY_DIRECTORY, ...)")
    parser.add_argument("--root-path", default=None, help="Dataset root path")
    parser.add_argument("--sequence", default=None, help="Only this sequence")
    parser.add_argument("--max-frames", type=int, default=-1)
    parser.add_argument("--output-dir", default=".outputs")
    parser.add_argument("--no-output", action="store_true")
    parser.add_argument("--html-viewer", action="store_true",
                        help="Write an interactive standalone viewer.html "
                             "per sequence (map + trajectory; the viz3d "
                             "window analog)")
    parser.add_argument("--trace-dir", default=None, metavar="DIR",
                        help="Record the run with torch.profiler and write "
                             "DIR/trace.json (open with Perfetto or "
                             "chrome://tracing) — the analog of the "
                             "reference's per-phase chrono instrumentation "
                             "(SlamCore/timer.h)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the odometry (default cuda; "
                             "cpu runs each kernel's plain version)")
    args = parser.parse_args(argv)

    from ct_icp_torch.config import options as O
    from ct_icp_torch.config.yaml_config import (RunnerConfig,
                                               load_runner_config)
    from ct_icp_torch.runner import OdometryRunner

    if args.config:
        cfg = load_runner_config(args.config)
    else:
        profile = {
            "driving": O.default_driving_profile,
            "robust_driving": O.robust_driving_profile,
            "robust_outdoor": O.default_robust_outdoor_low_inertia,
        }[args.profile]()
        cfg = RunnerConfig(odometry_options=profile)

    if args.dataset:
        from ct_icp_torch.datasets.dataset import DatasetEnum, DatasetOptions
        dopt = DatasetOptions(dataset=DatasetEnum[args.dataset],
                              root_path=args.root_path or "")
        if args.sequence:
            dopt.sequence_options = [{"sequence_name": args.sequence}]
        cfg.dataset_options = [dopt]
    if args.max_frames > 0:
        cfg.max_frames = args.max_frames
    if args.no_output:
        cfg.output_results = False
    if args.html_viewer:
        cfg.html_viewer = True
    cfg.output_dir = args.output_dir

    if not cfg.dataset_options:
        parser.error("No datasets configured (use -c config.yaml or --dataset)")

    runner = OdometryRunner(cfg, device=args.device)
    if args.trace_dir:
        ok = _traced_run(runner, args.trace_dir, args.device)
    else:
        ok = runner.run()
    for name, r in runner.results.items():
        line = (f"[{name}] frames={r.num_frames} "
                f"avg={r.avg_runtime_ms:.1f} ms/frame")
        if r.metrics is not None:
            line += (f" MEAN_RPE={r.metrics.mean_rpe:.4f}% "
                     f"MEAN_APE={r.metrics.mean_ape:.3f} m")
        print(line)
    return 0 if ok else 1


def _traced_run(runner, trace_dir: str, device: str) -> bool:
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        ok = runner.run()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return ok


if __name__ == "__main__":
    sys.exit(main())
