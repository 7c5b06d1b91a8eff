"""The 500-frame synthetic urban drive (``configs/synthetic_long_drive.yaml``)
streamed end to end, as ``bench.py --long`` runs it in the reference.

The scene is a 5 x 3 grid of city blocks, the route ~380 m with two
90-degree corners and a slow-traffic section, 100,000 points a frame. The
drive is graded by KITTI segment RPE (%Tr, segments of 100-800 m): the gate
is a 3-seed mean <= 0.50 %Tr over seeds 7, 8 and 9 (the reference's
``LONG_TR_BOUND_PCT``, ``LONG_SEEDS``). The reference's frames/s floor is a
TPU figure and is not carried over.

:func:`stream_long_drive` renders the frames (beforehand, on a thread pool,
when ``prerender``; else in the prefetch workers), prepares them in a
:class:`~ct_icp_torch.odometry.concurrent.PrefetchIterator` and streams them
through ``odo.stream_frames(batch)``, then grades the trajectory.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ct_icp_torch.config.yaml_config import synthetic_sequence_from_yaml
from ct_icp_torch.evaluation.kitti import evaluate_poses
from ct_icp_torch.odometry.concurrent import PrefetchIterator

LONG_TR_BOUND_PCT = 0.50
LONG_SEEDS = (7, 8, 9)
LONG_CONFIG = "configs/synthetic_long_drive.yaml"
LONG_FRAMES = 500
LONG_BATCH = 16


def config_path() -> Path:
    return Path(__file__).resolve().parents[2] / LONG_CONFIG


def load_acquisition(seed: int):
    """The long drive's acquisition with scan-realization ``seed``."""
    return synthetic_sequence_from_yaml(str(config_path()), seed=seed)


def stream_long_drive(odo, acq, num_frames: int = LONG_FRAMES,
                      batch: int = LONG_BATCH, prerender: bool = True
                      ) -> dict:
    """Stream the first ``num_frames`` frames of ``acq`` (cut to whole
    batches, as the reference does) through ``odo`` and grade them. With
    ``prerender`` the frames are rendered first, on one thread per core;
    without, in the prefetch workers. On the card each batch end is
    synchronized before its time is taken. Returns the run's numbers:
    frames, failures, %Tr, APE, the median per-batch frames/s after two
    warm-up batches, the render and the stream times, host syncs a frame,
    rebases, map points."""
    n = min(num_frames, acq.num_frames())
    n = max(batch, (n // batch) * batch)
    t0 = time.time()
    cache = None
    if prerender:
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            cache = list(pool.map(acq.frame, range(n)))
    render_s = time.time() - t0

    def prepare(i):
        fr = cache[i] if cache is not None else acq.frame(i)
        prep = odo.prepare_frame(fr["xyz"], fr["timestamps"], i, frame_id=i)
        return prep, fr["begin_pose"], fr["end_pose"]

    gt_ends = [None] * n
    gt_begin0 = [None]

    def preps():
        with PrefetchIterator(range(n), prepare, depth=2 * batch) as it:
            for prep, bp, ep in it:
                i = prep["info"].registered_fid
                gt_ends[i] = ep
                if i == 0:
                    gt_begin0[0] = bp
                yield prep

    failures = 0
    burst_ends = []
    t_stream = time.time()
    for i, s in enumerate(odo.stream_frames(preps(), batch=batch)):
        failures += not s.success
        if (i + 1) % batch == 0:
            if odo.device.type == "cuda":
                torch.cuda.synchronize()
            if i + 1 >= 2 * batch:
                burst_ends.append(time.time())
    stream_s = time.time() - t_stream
    traj = odo.get_trajectory()
    gt = [gt_begin0[0].inverse() * p for p in gt_ends[:len(traj)]]
    err = evaluate_poses(gt, [f.end_pose for f in traj], driving=True)
    fps = [batch / d for d in np.diff(burst_ends)]
    return dict(
        frames=len(traj), failures=int(failures), tr_pct=float(err.mean_rpe),
        mean_ape_m=float(err.mean_ape), max_ape_m=float(err.max_ape),
        segments=len(err.tab_errors),
        median_batch_fps=float(np.median(fps)) if fps else None,
        render_s=render_s, stream_s=stream_s, prerendered=bool(prerender),
        host_syncs_per_frame=odo.host_syncs / max(len(traj), 1),
        rebases=odo.rebases, map_points=odo.map_size(),
        origin=[float(x) for x in odo.origin], batch=batch)
