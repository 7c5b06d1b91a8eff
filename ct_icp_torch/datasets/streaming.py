"""A synthetic acquisition streamed end to end and graded, as the
reference's ``bench.py`` runs its long drive and its indoor walk
(``datasets/long_drive.py``, ``datasets/indoor_walk.py``).

:func:`stream_acquisition` renders the frames (beforehand, on a thread
pool, when ``prerender``; else in the prefetch workers), prepares them in a
:class:`~ct_icp_torch.odometry.concurrent.PrefetchIterator` and streams
them through ``odo.stream_frames(batch)``, then grades the trajectory by
segment RPE and APE. :class:`CachedAcquisition` keeps the rendered frames,
so that a second stream of the same frames (the backend gate's backend-off
run) renders nothing.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ct_icp_torch.evaluation.kitti import evaluate_poses
from ct_icp_torch.odometry.concurrent import PrefetchIterator


class CachedAcquisition:
    """An acquisition whose frames are rendered once and kept."""

    def __init__(self, acq):
        self.acq = acq
        self._frames = {}

    def num_frames(self) -> int:
        return self.acq.num_frames()

    def frame(self, i: int):
        fr = self._frames.get(i)
        if fr is None:
            fr = self._frames[i] = self.acq.frame(i)
        return fr


def stream_acquisition(odo, acq, num_frames: int, batch: int,
                       prerender: bool = True, driving: bool = True) -> dict:
    """Stream the first ``num_frames`` frames of ``acq`` (cut to whole
    batches, as the reference does) through ``odo`` and grade them, by the
    KITTI segment lengths (100-800 m) or, with ``driving=False``, the
    INDOOR ones (10-80 m), as ``evaluate_poses`` takes the flag.
    With ``prerender`` the frames are rendered first, on one thread per
    core; without, in the prefetch workers. On the card each batch end is
    synchronized before its time is taken. Returns the run's numbers:
    frames, failures, %Tr, APE, the median per-batch frames/s after two
    warm-up batches, the render and the stream times, attempts and host
    syncs a frame, rebases, map points."""
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

    failures = attempts = 0
    burst_ends = []
    t_stream = time.time()
    for i, s in enumerate(odo.stream_frames(preps(), batch=batch)):
        failures += not s.success
        attempts += s.number_of_attempts
        if (i + 1) % batch == 0:
            if odo.device.type == "cuda":
                torch.cuda.synchronize()
            if i + 1 >= 2 * batch:
                burst_ends.append(time.time())
    stream_s = time.time() - t_stream
    traj = odo.get_trajectory()
    gt = [gt_begin0[0].inverse() * p for p in gt_ends[:len(traj)]]
    err = evaluate_poses(gt, [f.end_pose for f in traj], driving=driving)
    fps = [batch / d for d in np.diff(burst_ends)]
    return dict(
        frames=len(traj), failures=int(failures), tr_pct=float(err.mean_rpe),
        mean_attempts=attempts / max(len(traj), 1),
        mean_ape_m=float(err.mean_ape), max_ape_m=float(err.max_ape),
        segments=len(err.tab_errors),
        median_batch_fps=float(np.median(fps)) if fps else None,
        render_s=render_s, stream_s=stream_s, prerendered=bool(prerender),
        host_syncs_per_frame=odo.host_syncs / max(len(traj), 1),
        rebases=odo.rebases, map_points=odo.map_size(),
        origin=[float(x) for x in odo.origin], batch=batch)
