"""Sliding-window continuous-time bundle-adjustment backend.

Counterpart of ``ct_icp_tpu/odometry/backend.py`` on one device: keep the
keypoints of the last ``window`` keyframes (on the host, as the streamer
reconstructs them), every ``period`` registered frames re-associate them
against the current map (``make_assemble_fn``: one K1 + K2 search over all
the window's keypoints) and refine their begin/end poses jointly with the
CT-BA step of ``parallel/ct_ba.py`` (one K8 launch a refine). The front
end stays as it is: the backend smooths the trajectory after the fact.

The refinement is applied one period late, as the reference does: a refine
dispatches its work, copies the packed [F, 14] result into pinned host
memory without blocking and records a CUDA event; the next refine (or
``flush``, which ``Odometry.get_trajectory`` calls) waits on that event
alone and writes the poses into the trajectory. A ``.cpu()`` there would
wait for everything queued on the stream, the next batch already dispatched
included: the stall the reference measured at 340 ms a refine. A refine
reads nothing else back. Its event waits are counted in ``event_waits``,
beside (not in) ``Odometry.host_syncs``.

With ``replay`` the apply is synchronous, as in the reference: the refine
reads the refined poses back at once (one host sync), writes them into the
trajectory and calls ``Odometry.replay_refined_frames``, so that the map
reflects them before the next frame registers.

A frame's keypoints arrive as numpy arrays (the streamer's and the
per-frame prefix path's host reconstructions) or as tensors on the device
(a frame step's device election, the robust profiles' escalated attempts);
a refine uploads the former in one pinned copy and stacks all on the
device.

Not ported: the mesh (ROADMAP queue A item 3).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.odometry import pipeline as pl
from ct_icp_torch.parallel import ct_ba


def make_assemble_fn(level_index: int, nv: int, resolution: float,
                     min_neighbors: int = 10,
                     point_block_scale: float = 10.0,
                     prior_weight: float = 1.5,
                     max_dist_to_plane: float = 0.3):
    """The associator: keyframe keypoints + map -> ``CTBAProblem``
    (reference ``make_assemble_fn``, the same weighting).

    * Point rows carry a2D^2 weights, gated by validity, at least
      ``min_neighbors`` in-radius map points and a plane distance under
      ``max_dist_to_plane``, then rescaled per frame so that the sum of
      squared weights is ``point_block_scale``^2.
    * Prior rows anchor each pose pair to its assembly-time estimate with
      ``prior_weight``.

    All F x K keypoints are searched in one ``voxel_map.ball_search_moments``
    (one K1 and one K2 launch on the card)."""

    def assemble(levels, raw, alphas, valid, qb, tb, qe, te, radius: float,
                 edge_alpha) -> ct_ba.CTBAProblem:
        # raw [F, K, 3], alphas / valid [F, K]; poses [F, 4] / [F, 3]
        f, k = raw.shape[0], raw.shape[1]
        world = ct_ba.interp_world_points(qb, tb, qe, te, raw, alphas)
        mom = vm.ball_search_moments(levels[level_index],
                                     world.reshape(f * k, 3).contiguous(),
                                     valid.reshape(f * k), radius,
                                     resolution, nv)
        count = mom.count.reshape(f, k)
        closest = mom.closest.reshape(f, k, 3)
        normal = mom.normal.reshape(f, k, 3)
        a2d = mom.a2d.reshape(f, k)
        # outlier gating (ct_icp.cpp:598 gates by max_dist_to_plane):
        # associations far from their plane are edge / corner mismatches
        d_plane = torch.abs(torch.sum((world - closest) * normal, dim=-1))
        keep = valid & (count >= min_neighbors) & (d_plane < max_dist_to_plane)
        w = torch.where(keep, a2d * a2d, torch.zeros_like(a2d))
        w = w * (point_block_scale / torch.sqrt(torch.clamp_min(
            torch.sum(w * w, dim=-1, keepdim=True), 1e-12)))
        return ct_ba.CTBAProblem(
            raw=raw, alphas=alphas, anchors=closest.contiguous(),
            normals=normal.contiguous(), weights=w.contiguous(),
            prior_quat_begin=qb, prior_tr_begin=tb, prior_quat_end=qe,
            prior_tr_end=te,
            prior_weight=torch.full((f,), prior_weight, dtype=raw.dtype,
                                    device=raw.device),
            edge_alpha=edge_alpha)

    return assemble


class CTBABackend:
    """Attachable sliding-window refinement for an ``Odometry``."""

    def __init__(self, odometry, window: int = 8, period: int = 8,
                 num_steps: int = 2, keep_first_frames: int = 2,
                 replay: bool = False, prior_weight: float = 1.5,
                 continuity_beta: float = 2.0):
        self.odometry = odometry
        self.window = window
        self.period = period
        self.num_steps = num_steps
        self.keep_first = keep_first_frames
        # propagate refinements into the map (Odometry.replay_refined_frames)
        self.replay = replay
        reg = odometry.registration
        self.assemble = make_assemble_fn(
            reg.level_index, reg.statics.voxel_neighborhood,
            reg.voxel_resolution, prior_weight=prior_weight)
        # the num_steps steps of 2 inner iterations run as one step of
        # 2 x num_steps (one K8 launch): a block-Jacobi step repacks the
        # poses it returns, so the iterations chain as they would across
        # steps, bit for bit
        self.step = ct_ba.make_ct_ba_step(num_inner_iters=2 * num_steps,
                                          beta=continuity_beta)
        self._keypoints: List[tuple] = []   # (fid, raw, alphas, valid)
        self._count = 0
        self.refinements = 0
        self.refine_ms: List[float] = []    # host ms of each refine() call
        # host waits of the deferred apply (one CUDA event each), counted
        # beside Odometry.host_syncs
        self.event_waits = 0
        # the deferred apply: (host [F, 14], event or None, fids, origin)
        self._pending = None
        odometry.register_callback(type(odometry).FINISHED_REGISTRATION,
                                   self._on_finished)

    # ------------------------------------------------------------------ hooks —
    def _on_finished(self, odometry, summary, keypoints=None) -> bool:
        if summary is None or summary.keypoints is None:
            return True
        fid = len(odometry.trajectory) - 1
        raw, alphas, valid = summary.keypoints
        self._keypoints.append((fid, raw, alphas, valid))
        if len(self._keypoints) > self.window:
            self._keypoints.pop(0)
        self._count += 1
        if self._count % self.period == 0 and len(self._keypoints) >= 2:
            self.refine()
        return True

    # ------------------------------------------------------------- refinement —
    def refine(self):
        t0 = time.perf_counter()
        try:
            self._refine()
        finally:
            self.refine_ms.append((time.perf_counter() - t0) * 1e3)

    def _apply_pending(self):
        """Write a deferred refinement into the trajectory, after waiting
        on its copy's event (long complete by now: a period has passed)."""
        if self._pending is None:
            return
        host, event, fids, origin = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
            self.event_waits += 1
        rows = host.numpy().astype(np.float64)         # [F, 14]
        odo = self.odometry
        for i, f in enumerate(fids):
            fr = odo.trajectory[f]
            fr.begin_pose.quat = s3n.quat_normalize(rows[i, 0:4])
            fr.begin_pose.tr = rows[i, 4:7] + origin
            fr.end_pose.quat = s3n.quat_normalize(rows[i, 7:11])
            fr.end_pose.tr = rows[i, 11:14] + origin
        self.refinements += 1

    def flush(self):
        """Apply any deferred refinement (``Odometry.get_trajectory`` calls
        it before handing the trajectory out)."""
        self._apply_pending()

    def _refine(self):
        self._apply_pending()
        odo = self.odometry
        # the anchor frames are never refined
        kps = [kp for kp in self._keypoints if kp[0] >= self.keep_first]
        if len(kps) < 2:
            return
        fids = [kp[0] for kp in kps]
        origin = odo.origin.copy()
        frames = [odo.trajectory[f] for f in fids]
        # edge_alpha: where frame f's interpolation reaches begin(f+1)'s
        # timestamp (> 1 across a gap between keyframes)
        ea = np.ones(len(fids), np.float32)
        for i in range(len(fids) - 1):
            f0, f1 = frames[i], frames[i + 1]
            dur = f0.end_pose.timestamp - f0.begin_pose.timestamp
            if dur > 0:
                ea[i] = (f1.begin_pose.timestamp
                         - f0.begin_pose.timestamp) / dur
        f32 = np.float32
        # the keypoints held on the host go up in the poses' upload, three
        # arrays a frame (raw, alphas, valid as float32)
        on_host = [i for i, kp in enumerate(kps)
                   if isinstance(kp[1], np.ndarray)]
        host = [np.asarray(kps[i][j], f32) for i in on_host for j in (1, 2, 3)]
        host += [
            np.stack([s3n.quat_normalize(fr.begin_pose.quat)
                      for fr in frames]).astype(f32),
            np.stack([fr.begin_pose.tr - origin for fr in frames]).astype(f32),
            np.stack([s3n.quat_normalize(fr.end_pose.quat)
                      for fr in frames]).astype(f32),
            np.stack([fr.end_pose.tr - origin for fr in frames]).astype(f32),
            ea]
        dev = pl.upload(host, odo.device)
        qb, tb, qe, te, ea_d = dev[-5:]
        rows = [kp[1:] for kp in kps]
        for n, i in enumerate(on_host):
            rows[i] = (dev[3 * n], dev[3 * n + 1], dev[3 * n + 2] != 0)
        raw = torch.stack([r[0] for r in rows])
        alphas = torch.stack([r[1] for r in rows])
        valid = torch.stack([r[2] for r in rows])
        problem = self.assemble(odo.map_state, raw, alphas, valid, qb, tb,
                                qe, te,
                                float(f32(odo.registration.search_radius)),
                                ea_d)
        state, _cost = self.step(ct_ba.CTBAState(qb, tb, qe, te), problem)
        packed = ct_ba.pack_state(state)
        if self.replay:
            # the map must reflect the refined poses before the next frame
            # registers, or its inserts wash the refinement out: apply now
            self._pending = (packed.cpu(), None, fids, origin)
            odo.host_syncs += 1
            self._apply_pending()
            odo.replay_refined_frames([odo.trajectory[f] for f in fids])
            return
        if packed.device.type == "cuda":
            out = torch.empty(packed.shape, dtype=packed.dtype,
                              pin_memory=True)
            out.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            out, event = packed, None
        self._pending = (out, event, fids, origin)
