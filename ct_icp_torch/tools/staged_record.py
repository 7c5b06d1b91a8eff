"""Frame-by-frame record of the staged per-frame path on the driving
corridor: what each frame's registration decided, and the numbers that fed
each decision.

    python -m ct_icp_torch.tools.staged_record [--runs adaptive_robust]
        [--frames 80] [--device cpu|cuda] [--out FILE]

The runs are ``chip_smoke.py``'s staged runs (``adaptive``,
``adaptive_robust``; corridor seed ``APE_SEEDS[0]``, the first
``--frames`` of 80 rendered frames) through ``Odometry.register_frame``,
one frame at a time. For each frame the record holds:

- the sub-frame's count and a SHA-256 of its valid rows (K4's output);
- each attempt: its robust level, keypoint count and a SHA-256 of the
  elected keypoint indices (K13), the ICP iterations and success, the
  relative and ego orientation and the relative distance that
  ``_assess_registration`` compared, and what it returned;
- the insert decision, the map size, and the begin and end poses.

:func:`record` works on any odometry object with this package's method
names (``tests/torch_staged_reference.py --per-frame`` records the JAX
package's with it), and :func:`first_divergence` finds the first frame at
which two records part: the sub-frame, then the keypoints, then the
attempts and their decisions, then the end pose beyond ``pose_tol_m``.
Writes the records as JSON to ``--out`` (default
``build/staged_record_<device>.json``) and prints one summary line a
run. Each attempt's keypoint indices are read back, one host sync more an
attempt than the staged runs of ``chip_smoke.py`` make: use this tool for
the decisions, not for times.
"""

import argparse
import dataclasses
import hashlib
import json
import sys
import time
import types
from pathlib import Path

import numpy as np

RUNS = ("adaptive", "adaptive_robust")


def _np(x):
    """A host numpy copy of a torch tensor or of any array-like."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _pose(p) -> list:
    return [float(v) for v in np.concatenate([p.quat, p.tr])]


def record(odo, odometry_module, frames, first: int = 0) -> list:
    """Register ``frames`` on ``odo`` one at a time through
    ``register_frame`` (frame ids from ``first``) and return one dict a
    frame. ``odometry_module`` is
    the module that defines ``type(odo)``: its ``smp`` sampler module is
    wrapped for the run so that each ADAPTIVE election's indices are
    seen."""
    pending = []
    attempts = []
    sub_seen = []
    smp = odometry_module.smp
    elect = smp.adaptive_grid_sampling_indices

    def adaptive(points, valid, options, capacity):
        out = elect(points, valid, options, capacity)
        idx, _, cnt = out
        pending.append(_np(idx)[:int(_np(cnt))].astype(np.int32))
        return out

    init = odo._initialize_frame

    def initialize(xyz, timestamps, info):
        out = init(xyz, timestamps, info)
        sub_raw, _, _, cnt = out
        sub_seen.append((cnt, _digest(_np(sub_raw)[:cnt].astype(np.float32))))
        return out

    assess = odo._assess_registration

    def assessed(summary):
        ok = assess(summary)
        idx = pending.pop() if pending else None
        attempts.append(dict(
            level=int(summary.robust_level),
            keypoints=int(summary.sample_size),
            kp_digest=None if idx is None else _digest(idx),
            iters=int(summary.icp_summary.num_iters),
            success=bool(summary.success),
            relative_orientation=float(summary.relative_orientation),
            ego_orientation=float(summary.ego_orientation),
            relative_distance=float(summary.relative_distance),
            assess=bool(ok),
            end=_pose(summary.frame.end_pose)))
        return ok

    odometry_module.smp = types.SimpleNamespace(
        **{k: getattr(smp, k) for k in dir(smp) if not k.startswith("__")})
    odometry_module.smp.adaptive_grid_sampling_indices = adaptive
    odo._initialize_frame = initialize
    odo._assess_registration = assessed
    out = []
    try:
        for i, f in enumerate(frames, first):
            attempts.clear()
            sub_seen.clear()
            s = odo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
            fr = odo.trajectory[i]
            out.append(dict(
                frame=i, sub_count=int(sub_seen[0][0]),
                sub_digest=sub_seen[0][1], attempts=list(attempts),
                number_of_attempts=int(s.number_of_attempts),
                success=bool(s.success), inserted=bool(s.points_added),
                map_size=int(odo.map_size()),
                begin=_pose(fr.begin_pose), end=_pose(fr.end_pose)))
    finally:
        odometry_module.smp = smp
        del odo._initialize_frame, odo._assess_registration
    return out


def _decisions(a) -> list:
    return [(x["level"], x["keypoints"], x["iters"], x["success"],
             x["assess"]) for x in a["attempts"]]


def first_divergence(ref: list, got: list, pose_tol_m: float = 1e-3):
    """The first frame at which ``got`` parts from ``ref``, and in what:
    (frame, what, detail), or None where every frame agrees. Checked in
    order a frame: the sub-frame, the keypoints, the attempts' decisions,
    the insert decision, the end pose beyond ``pose_tol_m``."""
    for r, g in zip(ref, got):
        i = r["frame"]
        if (r["sub_count"], r["sub_digest"]) != (g["sub_count"],
                                                 g["sub_digest"]):
            return i, "sub-frame", (r["sub_count"], g["sub_count"])
        kr = [(x["keypoints"], x["kp_digest"]) for x in r["attempts"]]
        kg = [(x["keypoints"], x["kp_digest"]) for x in g["attempts"]]
        if kr[:len(kg)] != kg[:len(kr)]:
            return i, "keypoints", (kr, kg)
        if _decisions(r) != _decisions(g):
            return i, "attempts", (_decisions(r), _decisions(g))
        if r["inserted"] != g["inserted"]:
            return i, "insert", (r["inserted"], g["inserted"])
        gap = float(np.linalg.norm(np.subtract(r["end"][4:], g["end"][4:])))
        if gap > pose_tol_m:
            return i, "end pose", gap
    return None


def summary(rec: list) -> dict:
    """The run's attempts a frame, frames escalated and end-pose track."""
    att = [f["number_of_attempts"] for f in rec]
    return dict(frames=len(rec), mean_attempts=float(np.mean(att)),
                escalated=sum(a > 1 for a in att),
                inserted=sum(f["inserted"] for f in rec),
                failures=sum(not f["success"] for f in rec),
                map_size=rec[-1]["map_size"])


def threshold_report(ref: list, got: list, options) -> dict:
    """Where the attempts of two records part: the first frame whose
    attempt counts differ, each record's relative distances there beside
    ``robust_relative_trans_threshold``, and over the reference's attempts
    the share within 2 % of that threshold and the nearest one."""
    thr = options.robust_relative_trans_threshold
    first = next((r["frame"] for r, g in zip(ref, got)
                  if r["number_of_attempts"] != g["number_of_attempts"]),
                 None)
    dists = [a["relative_distance"] for f in ref for a in f["attempts"]]
    out = dict(threshold_m=thr, first_frame_attempts_differ=first,
               attempts=len(dists),
               within_2pct=sum(abs(d - thr) <= 0.02 * thr for d in dists),
               nearest_m=min((abs(d - thr) for d in dists), default=None))
    if first is not None:
        out["relative_distance_m_at_first"] = [
            [a["relative_distance"] for a in rec[first]["attempts"]]
            for rec in (ref, got)]
    return out


def run_options(name: str):
    """The options of ``chip_smoke.py``'s staged run ``name``."""
    from ct_icp_torch.config.options import (SamplingOption,
                                             default_driving_profile)
    d = default_driving_profile()
    if name == "adaptive":
        return dataclasses.replace(d, sampling=SamplingOption.ADAPTIVE)
    if name == "adaptive_robust":
        return dataclasses.replace(d, sampling=SamplingOption.ADAPTIVE,
                                   robust_registration=True)
    raise ValueError(name)


def corridor_frames(n: int, rendered: int = 80):
    """The first ``n`` of ``chip_smoke.py``'s staged frames."""
    from ct_icp_torch.datasets import corridor as cor
    scene = cor.build_scene()
    traj = cor.straight_trajectory(400, rendered * 0.1 + 0.5)
    return cor.render_corridor(scene, traj, n, cor.APE_SEEDS[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch

    from ct_icp_torch.datasets import corridor as cor
    from ct_icp_torch.odometry import odometry as todo
    if a.device == "cpu":
        torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    elif not torch.cuda.is_available():
        sys.exit("staged_record: no CUDA device (pass --device cpu)")
    frames = corridor_frames(a.frames)
    recs = {}
    for name in a.runs.split(","):
        t0 = time.time()
        odo = todo.Odometry(run_options(name), device=a.device)
        recs[name] = record(odo, todo, frames)
        errs = cor.seq_ape(odo, frames)
        print(json.dumps({name: dict(summary(recs[name]),
                                     device=a.device,
                                     mean_ape_m=float(np.mean(errs)),
                                     seconds=time.time() - t0)}),
              flush=True)
    out = Path(a.out or f"build/staged_record_{a.device}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(recs))
    print(f"records -> {out}")


if __name__ == "__main__":
    main()
