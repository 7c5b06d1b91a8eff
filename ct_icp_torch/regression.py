"""Golden-metric regression harness.

Counterpart of the reference regression runner
(reference test/regression/regression_run.cxx:106-443 + the baseline YAMLs):
replay configured sequences, compare the KITTI mean RPE (``kitti_Tr``) and the
average runtime per frame against per-sequence baselines, fail on regressions
beyond the tolerances, and write an updated baseline YAML.

Baseline YAML shape (mirrors regression_config_short_drive.yaml):

    tolerance_tr: 1.e-5
    tolerance_time_sec: 1.e-3
    runs:
      - sequence_name: "00"
        kitti_Tr: 1.0
        avg_runtime_sec: 0.0855
        max_num_frames: 500
    dataset_options: {...}
    odometry_options: {...}

Counterpart of ``ct_icp_tpu/regression.py``. The port reads the YAML with
its own reader (``config/yaml_config.py::read_yaml``) and writes the updated
baseline with :func:`dump_yaml`, whose output that reader reads back to the
same values. ``run_regression`` and ``main`` take the odometry's device
(default the card).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional

from ct_icp_torch.config.yaml_config import (RunnerConfig, read_yaml,
                                             yaml_to_dataset_options,
                                             yaml_to_odometry_options)
from ct_icp_torch.datasets.dataset import Dataset, is_driving_dataset
from ct_icp_torch.runner import OdometryRunner, SequenceResult


@dataclasses.dataclass
class RegressionRun:
    sequence_name: str
    kitti_Tr: float = -1.0
    avg_runtime_sec: float = -1.0
    #: mean absolute position error baseline (meters). The reference gates
    #: only on Tr; synthetic scenes are too short for segment RPE to bite,
    #: so APE is the teeth of the synthetic gate.
    mean_ape_m: float = -1.0
    max_num_frames: int = -1
    init_frame: int = 0


@dataclasses.dataclass
class RegressionConfig:
    tolerance_tr: float = 1e-5           # reference regression_run.cxx:145
    tolerance_time_sec: float = 1e-3     # reference regression_run.cxx:146
    tolerance_ape_m: float = 1e-3
    runs: List[RegressionRun] = dataclasses.field(default_factory=list)
    dataset_options: Optional[object] = None
    odometry_options: Optional[object] = None


def load_regression_config(path) -> RegressionConfig:
    root = read_yaml(path)
    cfg = RegressionConfig()
    cfg.tolerance_tr = float(root.get("tolerance_tr", cfg.tolerance_tr))
    cfg.tolerance_time_sec = float(
        root.get("tolerance_time_sec", cfg.tolerance_time_sec))
    cfg.tolerance_ape_m = float(
        root.get("tolerance_ape_m", cfg.tolerance_ape_m))
    for r in root.get("runs", []):
        cfg.runs.append(RegressionRun(
            sequence_name=str(r["sequence_name"]),
            kitti_Tr=float(r.get("kitti_Tr", -1.0)),
            avg_runtime_sec=float(r.get("avg_runtime_sec", -1.0)),
            mean_ape_m=float(r.get("mean_ape_m", -1.0)),
            max_num_frames=int(r.get("max_num_frames", -1)),
            init_frame=int(r.get("init_frame", 0))))
    if "dataset_options" in root:
        cfg.dataset_options = yaml_to_dataset_options(root["dataset_options"])
    if "odometry_options" in root:
        cfg.odometry_options = yaml_to_odometry_options(root["odometry_options"])
    return cfg


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        # YAML 1.1 reads a float only with a dot and a signed exponent
        # (1e-05 would be a string)
        mant, _, exp = repr(v).partition("e")
        if "." not in mant:
            mant += ".0"
        if exp and exp[0] not in "+-":
            exp = "+" + exp
        return mant + (f"e{exp}" if exp else "")
    if isinstance(v, int):
        return str(v)
    return '"' + str(v) + '"'


def dump_yaml(node, indent: int = 0) -> str:
    """Block YAML of nested dicts, lists and scalars, keys sorted as
    ``yaml.safe_dump`` sorts them, which ``read_yaml`` reads back to the
    same values: strings double-quoted (no escapes: the names of
    sequences), floats with a dot."""
    pad = " " * indent
    lines = []
    if isinstance(node, dict):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}{k}:")
                lines.append(dump_yaml(v, indent + 2))
            else:
                lines.append(f"{pad}{k}: " + (
                    "[]" if isinstance(v, list) else _yaml_scalar(v)))
    else:
        for v in node:
            if isinstance(v, dict) and v:
                lines.append(f"{pad}- " + dump_yaml(v, indent + 2).lstrip())
            else:
                lines.append(f"{pad}- " + _yaml_scalar(v))
    return "\n".join(lines)


def run_regression(cfg: RegressionConfig, output_path: Optional[str] = None,
                   device=None) -> bool:
    """Run all configured sequences; True iff no precision/time regression."""
    assert cfg.dataset_options is not None and cfg.odometry_options is not None
    dataset = Dataset.load_dataset(cfg.dataset_options)
    driving = is_driving_dataset(cfg.dataset_options.dataset)
    runner = OdometryRunner(RunnerConfig(
        odometry_options=cfg.odometry_options, output_results=False,
        progress_bar=False, compute_metrics_period=0), device=device)

    all_ok = True
    new_runs = []
    for run in cfg.runs:
        if not dataset.has_sequence(run.sequence_name):
            print(f"[regression] sequence {run.sequence_name} not on disk — "
                  f"skipping", file=sys.stderr)
            new_runs.append(run)
            continue
        seq = dataset.sequence(run.sequence_name)
        if run.init_frame:
            seq.set_init_frame(run.init_frame)
        if run.max_num_frames > 0:
            seq.set_max_num_frames(run.max_num_frames)
        result: SequenceResult = runner.run_sequence(seq, driving=driving)
        tr = result.metrics.mean_rpe if result.metrics else float("inf")
        ape = result.metrics.mean_ape if result.metrics else float("inf")
        rt = result.avg_runtime_ms / 1e3
        ok = True
        if run.kitti_Tr >= 0 and tr > run.kitti_Tr + cfg.tolerance_tr:
            print(f"[regression] {run.sequence_name}: PRECISION regression "
                  f"Tr {tr:.4f}% > baseline {run.kitti_Tr:.4f}%")
            ok = False
        if run.mean_ape_m >= 0 and ape > run.mean_ape_m + cfg.tolerance_ape_m:
            print(f"[regression] {run.sequence_name}: PRECISION regression "
                  f"APE {ape:.4f}m > baseline {run.mean_ape_m:.4f}m")
            ok = False
        if run.avg_runtime_sec >= 0 and \
                rt > run.avg_runtime_sec + cfg.tolerance_time_sec:
            print(f"[regression] {run.sequence_name}: RUNTIME regression "
                  f"{rt:.4f}s > baseline {run.avg_runtime_sec:.4f}s")
            ok = False
        status = "OK" if ok else "FAILED"
        print(f"[regression] {run.sequence_name}: Tr={tr:.4f}% "
              f"APE={ape:.4f}m runtime={rt:.4f}s [{status}]")
        all_ok = all_ok and ok
        new_runs.append(RegressionRun(
            sequence_name=run.sequence_name, kitti_Tr=tr, avg_runtime_sec=rt,
            mean_ape_m=ape,
            max_num_frames=run.max_num_frames, init_frame=run.init_frame))

    if output_path:
        out = {
            "tolerance_tr": cfg.tolerance_tr,
            "tolerance_time_sec": cfg.tolerance_time_sec,
            "tolerance_ape_m": cfg.tolerance_ape_m,
            "runs": [dataclasses.asdict(r) for r in new_runs],
        }
        with open(output_path, "w") as f:
            f.write(dump_yaml(out) + "\n")
    return all_ok


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="regression_run")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-o", "--output", default=None,
                   help="Write the updated baseline YAML here")
    p.add_argument("--device", default="cuda",
                   help="torch device of the odometry (default cuda)")
    args = p.parse_args(argv)
    cfg = load_regression_config(args.config)
    return 0 if run_regression(cfg, args.output, device=args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
