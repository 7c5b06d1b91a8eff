"""K4 ``grid_sample`` on the card at the two shapes it is measured at, beside
a clear of its table: the cost that the persistent claim table removed.

    python -m ct_icp_torch.tools.exp_sample
    cd <other tree> && PYTHONPATH=$PWD python <this tree>/ct_icp_torch/tools/exp_sample.py

Inputs (as ``chip_smoke.py``'s K4 phase takes them): the robust corridor's
last frame (80 frames at 8 m/s, seed 3) prepared by
``robust_driving_profile()``, its sub-sample unpacked on the card (16,766
points); the robust escalation shape elects it at 1.0 m with a 2^22 table
and 4,096 kept at most, the Pallas shape zero-pads it to a multiple of
1,024 rows with a valid prefix and a 2^21 table.

It times ``grid_sample`` of the ``ct_icp_torch`` that Python imports: run
as a file with another tree's directory first on ``PYTHONPATH``, that
tree's kernel (how an earlier design is paired with this one in one call).
Three calls in a row on one table are held bit for bit to the plain
version first, then the call is timed on the device with the L2 flushed
before each call (``timing.time_cold``), back to back in a CUDA graph
(``timing.time_stateless``), and with its host side (:func:`time_host`:
the wrapper, its allocations and the launch). Beside them, the floor of a
clear of the table (its bytes at the HBM rate), which the five-launch
design paid every call, and a ``fill_`` of the table, timed. Prints one
line per measurement, one JSON line of them all and the card's name and
power limit. Needs one CUDA device: exits 2 without one.
"""

import json
import subprocess
import sys

import numpy as np
import torch

from ct_icp_torch.config.options import robust_driving_profile
from ct_icp_torch.datasets import corridor as cor
from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import grid_sample as k4
from ct_icp_torch.odometry import pipeline as pl
from ct_icp_torch.odometry.odometry import Odometry
from ct_icp_torch.tools import timing

FRAMES = 80


def time_host(fn, reps=50):
    """Mean ms of one ``fn()`` between an event recorded before the Python
    call and one recorded after it, the device idle before each: the
    host's enqueue (the wrapper's checks and allocation, the launch) and,
    where the device outlasts it, the device time. A copy of
    ``timing.time_host``, kept here so that this script runs against an
    earlier tree, whose ``timing`` lacks it. Returns (ms, method)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, "events around the call"


def shapes(dev):
    """[(tag, points, valid, voxel, capacity, table_log2)] at the robust
    escalation shape and the Pallas shape."""
    frames = cor.render_corridor(cor.build_scene(),
                                 cor.robust_corridor_trajectory(FRAMES),
                                 FRAMES, cor.APE_SEEDS[0])
    o = robust_driving_profile()
    odo = Odometry(o, device=dev)
    f = frames[-1]
    prep = odo.prepare_frame(f["xyz"], f["timestamps"], FRAMES - 1,
                             frame_id=FRAMES - 1)
    del odo
    raw, _ = pl.unpack_scan(torch.from_numpy(
        prep["scan_host"].view(np.int16)).to(dev))
    sub = raw[:prep["n"]].contiguous()
    voxel = max(o.sample_voxel_size / 1.5, min(o.init_voxel_size,
                                               o.voxel_size))
    n = sub.shape[0]
    n_pad = (n + 1023) // 1024 * 1024
    padded = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
    padded[:n] = sub
    return [("robust escalation", sub,
             torch.ones(n, dtype=torch.bool, device=dev), voxel,
             o.max_keypoints, 22),
            ("Pallas configuration", padded,
             torch.arange(n_pad, device=dev) < n, voxel, o.max_keypoints,
             21)]


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_sample: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print("card:", card, flush=True)
    print("kernel source:", k4.__file__, flush=True)
    build.build_all(["grid_sample"])
    rows = []

    def record(name, ms, **kw):
        rows.append(dict(name=name, ms=ms, **kw))
        extra = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"{name:64s} {ms:9.4f} ms  {extra}", flush=True)

    for tag, pts, valid, voxel, cap, t_log2 in shapes(dev):
        args = (pts, valid, voxel, cap, t_log2)
        want = k4.grid_sample_plain(*args)
        n_bytes = pts.shape[0] * 13 + cap * 5 + 4
        b_ms = timing.bound(n_bytes, pts.shape[0] * 12.0)[0]
        table_bytes = (1 << t_log2) * 4
        print(f"{tag}: N={pts.shape[0]} table 2^{t_log2} capacity {cap}, "
              f"{int(want[2])} kept; bound {b_ms:.6f} ms; the five-launch "
              f"design's table clear alone >= "
              f"{table_bytes / timing.HBM_BYTES_PER_S * 1e3:.5f} ms",
              flush=True)

        def fn():
            return k4.grid_sample(*args)

        for _ in range(3):      # consecutive calls on one table
            got = fn()
            torch.cuda.synchronize()
            for a, b, what in zip(got, want, ("idx", "out_valid", "count")):
                if not torch.equal(a, b):
                    raise AssertionError(f"K4 {tag}: {what} != plain")
        ms, _ = timing.time_cold(fn)
        warm_ms, _ = timing.time_stateless(fn)
        host_ms, _ = time_host(fn)
        record(f"K4 {tag}", ms, warm_ms=warm_ms, host_ms=host_ms,
               bound_ms=b_ms)
        table = torch.empty(1 << t_log2, dtype=torch.int32, device=dev)
        ms, _ = timing.time_cold(lambda: table.fill_(-1))
        record(f"fill_ of a 2^{t_log2} int32 table {tag}", ms,
               floor_ms=table_bytes / timing.HBM_BYTES_PER_S * 1e3)
        del table
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "kernel_source": k4.__file__, "rows": rows}),
          flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
