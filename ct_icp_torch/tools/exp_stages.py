"""Device operations, host syncs and frames/s a frame on the driving path
and the knn run, of this tree and of another, in one call on the card.

    rm -rf build/parent && mkdir -p build/parent && \\
        git archive HEAD | tar -x -C build/parent
    python -m ct_icp_torch.tools.exp_stages build/parent [--frames 80]

Runs ``tools/profile_stream.py`` (this tree's script) on the driving
profile and with ``--knn``, each in a process of its own (a fresh process:
its profile is its first trace), with the other tree's package and then
this tree's on ``PYTHONPATH``, in the order other, this, this, other, so
that a drift of the card between the readings shows. Prints each run's
JSON line and then one summary line: for each tree and profile, the
device operations a frame of the profiled batch, the host syncs a frame,
the device's busy share under the profiler, the unprofiled median frames/s
and the mean APE. Exits 1 where a run fails.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
SCRIPT = Path(__file__).resolve().parent / "profile_stream.py"
KEYS = ("device_ops_per_frame", "host_syncs_per_frame", "device_busy_share",
        "unprofiled_median_batch_fps", "wall_ms_per_frame", "mean_ape_m",
        "failures", "first_frame")


def run(tree: Path, profile: str, frames: int):
    env = dict(os.environ, PYTHONPATH=str(tree))
    cmd = [sys.executable, str(SCRIPT), "--frames", str(frames)]
    if profile != "driving":
        cmd.append(f"--{profile}")
    out = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                         text=True)
    if out.returncode != 0:
        print(out.stdout[-4000:], out.stderr[-4000:], flush=True)
        raise SystemExit(f"exp_stages: {tree} {profile} exited "
                         f"{out.returncode}")
    line = [x for x in out.stdout.splitlines() if x.startswith("{")][-1]
    print(f"{tree.name} {profile}: {line}", flush=True)
    return json.loads(line)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--frames", type=int, default=80)
    args = ap.parse_args()
    other = args.other.resolve()
    summary = {}
    for tree in (other, HERE, HERE, other):
        name = "this" if tree == HERE else "other"
        for profile in ("driving", "knn"):
            r = run(tree, profile, args.frames)
            summary.setdefault(f"{name} {profile}", []).append(
                {k: r.get(k) for k in KEYS})
            card = r["card"]
    print(json.dumps({"card": card, "runs": summary}), flush=True)


if __name__ == "__main__":
    main()
