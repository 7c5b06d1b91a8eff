"""The streaming odometry driver — host side around the device pipeline.

Counterpart of ``ct_icp_tpu/odometry/odometry.py::Odometry`` on the path
``bench.py --driving`` runs: ``prepare_frame`` (shuffle, exact host voxel
dedup on the wire-quantized coords, keypoint-prefix partition, u16 wire
packing) and ``stream_frames(preps, batch)`` (batches of frames through the
streaming body of odometry/pipeline.py, the map and the motion state resident
on the device, one readback per batch).

Not ported yet (raise rather than run something else): the robust
escalation regimen, the per-frame ``register_frame`` API, the map rebase
(``rebuild_level``), the device grid subsample and keypoint election, the
CT-BA backend and the frame ring.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ct_icp_torch import resolve_device
from ct_icp_torch.config.options import (CTICPOptions, Initialization,
                                         MotionCompensation, OdometryOptions,
                                         PoseParametrization, SamplingOption)
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.pose import Pose, TrajectoryFrame
from ct_icp_torch.icp.registration import CTICPRegistration
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.odometry import pipeline as pl

# Map-prune cadence (frames); the reference prunes every frame, at 100 m
# thresholds a few frames of lag is behaviorally free.
PRUNE_PERIOD = 8


@dataclasses.dataclass
class FrameInfo:
    """Reference Odometry::FrameInfo (odometry.h:201-205)."""

    registered_fid: int = -1
    frame_id: int = -1
    begin_timestamp: float = -1.0
    end_timestamp: float = -1.0


@dataclasses.dataclass
class ICPSummary:
    """Mirror of the reference ICPSummary (ct_icp.h:155-169)."""

    success: bool = False
    num_residuals_used: int = 0
    num_iters: int = 0
    error_log: str = ""


@dataclasses.dataclass
class RegistrationSummary:
    """Reference Odometry::RegistrationSummary (odometry.h:163-199)."""

    frame: TrajectoryFrame = dataclasses.field(default_factory=TrajectoryFrame)
    initial_frame: TrajectoryFrame = dataclasses.field(
        default_factory=TrajectoryFrame)
    sample_size: int = 0
    number_of_residuals: int = 0
    robust_level: int = 0
    distance_correction: float = 0.0
    relative_distance: float = 0.0
    relative_orientation: float = 0.0
    ego_orientation: float = 0.0
    success: bool = True
    points_added: bool = False
    number_of_attempts: int = 0
    error_message: str = ""
    icp_summary: ICPSummary = dataclasses.field(default_factory=ICPSummary)
    logged_values: Dict[str, float] = dataclasses.field(default_factory=dict)


class _InsertionTracker:
    """Reference FrameInsertionTracker (odometry.h:319-348)."""

    def __init__(self):
        self.last_inserted_frame_idx = 0
        self.cum_distance_since_insertion = 0.0
        self.cum_orientation_change_since_insertion = 0.0
        self.skipped_frames = 0
        self.total_insertions = 0

    def insert_frame(self, frame_id: int):
        self.last_inserted_frame_idx = frame_id
        self.cum_distance_since_insertion = 0.0
        self.cum_orientation_change_since_insertion = 0.0
        self.skipped_frames = 0
        self.total_insertions += 1

    def skip_frame(self):
        self.skipped_frames += 1


def _host_voxel_dedup(xyz: np.ndarray, voxel_size: float,
                      capacity: int) -> np.ndarray:
    """First-occurrence-per-voxel indices, in scan order (numpy): truncation
    toward zero, first in scan order wins, collision-free over +/-2^20
    voxels per axis (np.unique over a 21-bit-per-axis packed key)."""
    c = np.trunc(xyz / voxel_size).astype(np.int64)
    key = (((c[:, 0] & 0x1FFFFF) << 42) | ((c[:, 1] & 0x1FFFFF) << 21)
           | (c[:, 2] & 0x1FFFFF))
    _, first = np.unique(key, return_index=True)
    first.sort()
    return first[:capacity]


def _sanitize_scan(xyz, timestamps):
    """Contiguous float64 copies with non-finite points dropped. Raises on
    an empty result."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    timestamps = np.ascontiguousarray(timestamps, dtype=np.float64)
    finite = np.isfinite(xyz).all(axis=1) & np.isfinite(timestamps)
    if not finite.all():
        xyz, timestamps = xyz[finite], timestamps[finite]
    if xyz.shape[0] == 0:
        raise ValueError("The registered frame cannot be empty")
    return xyz, timestamps


def _apply_motion_compensation(options: OdometryOptions) -> OdometryOptions:
    """Reference Odometry ctor option rewriting (odometry.cpp:700-725)."""
    mc = options.motion_compensation
    icp = options.ct_icp_options
    if mc in (MotionCompensation.NONE, MotionCompensation.CONSTANT_VELOCITY):
        icp = dataclasses.replace(
            icp, point_to_plane_with_distortion=False,
            parametrization=PoseParametrization.SIMPLE)
    elif mc == MotionCompensation.ITERATIVE:
        icp = dataclasses.replace(
            icp, point_to_plane_with_distortion=True,
            parametrization=PoseParametrization.SIMPLE)
    else:  # CONTINUOUS
        icp = dataclasses.replace(
            icp, point_to_plane_with_distortion=True,
            parametrization=PoseParametrization.CONTINUOUS_TIME)
    return dataclasses.replace(options, ct_icp_options=icp)


class Odometry:
    """Continuous-time LiDAR odometry against a local voxel map on the card
    (``device="cuda"``, the default) or, for tests, the CPU."""

    def __init__(self, options: OdometryOptions, device=None):
        options = _apply_motion_compensation(options)
        if (options.robust_registration or not options.host_subsample
                or options.sampling != SamplingOption.GRID
                or options.max_num_keypoints > 0
                or options.motion_compensation
                == MotionCompensation.CONSTANT_VELOCITY
                or options.backend.enabled):
            raise NotImplementedError(
                "ct_icp_torch streams the non-robust, host-deduped, "
                "keypoint-prefix path only (e.g. default_driving_profile)")
        self.device = resolve_device(device)
        self.options = options
        self.map_options = options.map_options
        self.map_state = vm.make_map(self.map_options, self.device)
        self.origin = np.zeros(3, dtype=np.float64)
        self.rebase_distance = 500.0
        self.registration = CTICPRegistration(
            options.ct_icp_options, self.map_options,
            num_keypoints=options.max_keypoints)
        self._stream_step = pl.make_stream_body(
            self.map_options, self.registration.statics,
            sub_capacity=options.max_subsampled_points,
            const_velocity=(options.initialization
                            == Initialization.INIT_CONSTANT_VELOCITY),
            continuous=(options.motion_compensation
                        == MotionCompensation.CONTINUOUS),
            always_insert=options.always_insert,
            do_no_insert=options.do_no_insert)
        self._odo_state = torch.as_tensor(pl.init_odo_state(),
                                          device=self.device)
        self._startup_opts_cache = {}
        self.trajectory: List[TrajectoryFrame] = []
        self.registered_frames = 0
        self.insertion_tracker = _InsertionTracker()
        # device->host reads made by the solver loops (early exits)
        self.host_syncs = 0

    # ------------------------------------------------------------- public API —
    def map_size(self) -> int:
        return int(self.map_state[0].num_points[0])

    def get_trajectory(self) -> List[TrajectoryFrame]:
        return [f.copy() for f in self.trajectory]

    def prepare_frame(self, xyz: np.ndarray, timestamps: np.ndarray,
                      registered_fid: int, frame_id: Optional[int] = None
                      ) -> dict:
        """Host preparation of one scan (reference odometry.py:280-387):
        shuffle (deterministic per frame id), exact voxel dedup on the
        wire-quantized coords, keypoint-prefix partition (the grid-sample
        winners first), alpha-timestamps and the u16 wire packing.
        Thread-safe; ``registered_fid`` is the frame's position in the
        registration order."""
        xyz, timestamps = _sanitize_scan(xyz, timestamps)
        info = FrameInfo(
            registered_fid=registered_fid,
            frame_id=registered_fid if frame_id is None else frame_id,
            begin_timestamp=float(timestamps.min()),
            end_timestamp=float(timestamps.max()))
        o = self.options
        cap = o.max_scan_points
        n = xyz.shape[0]
        if n > cap:
            sel = np.random.default_rng(registered_fid).choice(
                n, cap, replace=False)
            xyz, timestamps = xyz[sel], timestamps[sel]
        # SHUFFLE before the voxel dedup (reference InitializeFrame,
        # odometry.cpp:349-361): first-per-voxel then draws a random
        # representative per voxel and the keypoint alphas stay uniform
        perm = np.random.default_rng(
            (0x5EED, info.frame_id)).permutation(xyz.shape[0])
        xyz, timestamps = xyz[perm], timestamps[perm]
        startup = registered_fid < o.init_num_frames
        v = o.init_voxel_size if startup else o.voxel_size
        q = np.rint(xyz * pl.SCAN_QUANT) / pl.SCAN_QUANT
        keep = _host_voxel_dedup(q, v, o.max_subsampled_points)
        xyz, timestamps = xyz[keep], timestamps[keep]
        n = xyz.shape[0]
        cap = min(cap, o.max_subsampled_points)
        # KEYPOINT PREFIX: stable-partition the deduped scan so the
        # sample-voxel grid winners (first in scan order) come first; the
        # device takes keypoints as that prefix
        v_kp = o.init_sample_voxel_size if startup else o.sample_voxel_size
        q = np.rint(xyz * pl.SCAN_QUANT) / pl.SCAN_QUANT
        kp_first = _host_voxel_dedup(q, v_kp, o.max_keypoints)
        mask = np.zeros(n, bool)
        mask[kp_first] = True
        order = np.concatenate([kp_first, np.nonzero(~mask)[0]])
        xyz, timestamps = xyz[order], timestamps[order]
        alphas = self._frame_alphas(timestamps, info)
        return {
            "info": info, "n": n,
            "scan_host": pl.pack_scan_u16(xyz, alphas, n,
                                          pl.scan_rung(cap, n)),
            "xyz": xyz, "timestamps": timestamps, "alphas": alphas,
            "kp_n": int(kp_first.shape[0]), "kp_voxel": float(v_kp),
        }

    def stream_frames(self, preps, batch: int = 1):
        """Register prepared frames in order (generator of
        RegistrationSummary). ``batch`` frames share one stacked upload and
        one readback of their results; the frames of a batch run one after
        another on the device. The last group may be shorter."""
        group = []
        for prep in preps:
            group.append(prep)
            if len(group) == max(batch, 1):
                yield from self._finish_batch(
                    *self._stream_frames_batched(group))
                group = []
        if group:
            yield from self._finish_batch(*self._stream_frames_batched(group))

    # ---------------------------------------------------------------- driver —
    def _betas(self):
        o = self.options
        mm = o.default_motion_model
        if not o.with_default_motion_model:
            return np.zeros(4, np.float32)
        return np.asarray([mm.beta_location_consistency,
                           mm.beta_orientation_consistency,
                           mm.beta_constant_velocity,
                           mm.beta_small_velocity], np.float32)

    def _frame_scalars(self, prep) -> np.ndarray:
        o = self.options
        k = prep["info"].registered_fid
        startup = k < o.init_num_frames
        fs1 = o.init_sample_voxel_size if startup else o.sample_voxel_size
        return np.asarray([
            o.init_voxel_size if startup else o.voxel_size,
            fs1,
            o.max_distance, 0.0, 0.0,
            o.insertion_ego_rotation_threshold, 0.0,
            o.insertion_threshold_frames_skipped,
            o.distance_error_threshold,
            o.orientation_error_threshold,
            1.0 if k % PRUNE_PERIOD == 0 else 0.0,
            np.inf, np.inf, np.inf, 0.0,
            # young-map insert budget (fs[15], see OdometryOptions)
            float(o.bootstrap_insert_rounds) if k < o.bootstrap_frames
            else 4.0,
            self._kp_prefix_scalar(prep, fs1),
        ], dtype=np.float32)

    @staticmethod
    def _kp_prefix_scalar(prep, fs1: float) -> float:
        """fs[16]: the keypoint-prefix count when the prep's partition was
        computed at this frame's sample voxel size, else 0."""
        kp_n = prep.get("kp_n", 0)
        if kp_n > 0 and abs(prep.get("kp_voxel", 0.0) - fs1) < 1e-9:
            return float(kp_n)
        return 0.0

    def _stream_frames_batched(self, group):
        """Upload one group's scans together and run its frames in order;
        returns (infos, packed results [B, 24] on the device, origin)."""
        rung = max(p["scan_host"].shape[0] for p in group)
        scans = np.zeros((len(group), rung, 4), np.uint16)
        for b, prep in enumerate(group):
            sh = prep["scan_host"]
            scans[b, :sh.shape[0]] = sh
        scans_dev = torch.from_numpy(scans.view(np.int16)).to(self.device)
        betas = torch.as_tensor(self._betas(), device=self.device)
        infos, packed = [], []
        for b, prep in enumerate(group):
            info = prep["info"]
            if info.registered_fid != self.registered_frames:
                raise ValueError("Prepared frames must be streamed in order")
            self.registered_frames += 1
            dyn = self.registration.dynamics(self._effective_icp_options(info))
            self._odo_state, row, syncs = self._stream_step(
                self.map_state, self._odo_state, scans_dev[b], prep["n"],
                info.registered_fid, betas, dyn, self._frame_scalars(prep))
            self.host_syncs += syncs
            infos.append(info)
            packed.append(row)
        return infos, torch.stack(packed), self.origin.copy()

    def _finish_batch(self, infos, packed_all, origin):
        rows = packed_all.cpu().numpy().astype(np.float64)
        for info, row in zip(infos, rows):
            yield self._finish_streamed(info, row, origin)

    def _finish_streamed(self, info, r, origin) -> RegistrationSummary:
        """Host bookkeeping of one streamed frame from its packed result."""
        k = info.registered_fid
        frame = TrajectoryFrame(
            Pose(timestamp=info.begin_timestamp, frame_id=info.frame_id),
            Pose(timestamp=info.end_timestamp, frame_id=info.frame_id))
        frame.begin_pose.quat = r[0:4]
        frame.begin_pose.tr = r[4:7] + origin
        frame.end_pose.quat = r[7:11]
        frame.end_pose.tr = r[11:14] + origin
        frame.begin_pose.normalize_()
        frame.end_pose.normalize_()
        self.trajectory.append(frame)

        summary = RegistrationSummary()
        summary.frame = frame
        summary.initial_frame = frame.copy()
        summary.number_of_residuals = int(r[14])
        summary.sample_size = int(r[19])
        summary.icp_summary.num_residuals_used = int(r[14])
        summary.icp_summary.num_iters = int(r[15])
        summary.icp_summary.success = bool(r[17])
        summary.points_added = bool(r[21])
        summary.logged_values["odometry_num_subsampled"] = int(r[18])
        summary.logged_values["map_inserted_points"] = int(r[20])
        self._compute_summary_metrics(summary, k)
        assess_ok = bool(r[22])
        summary.success = bool(r[17]) and (assess_ok or k == 0)
        if not summary.success and not assess_ok:
            summary.error_message = "Registration assessment failed"

        tracker = self.insertion_tracker   # host mirror (device authoritative)
        tracker.cum_orientation_change_since_insertion += \
            summary.relative_orientation
        tracker.cum_distance_since_insertion += summary.relative_distance
        if summary.points_added:
            tracker.insert_frame(k)
        else:
            tracker.skip_frame()

        if np.linalg.norm(frame.end_pose.tr - self.origin) \
                > self.rebase_distance:
            raise NotImplementedError(
                "map rebase (rebuild_level) is not ported: the trajectory "
                f"left the {self.rebase_distance} m map frame")
        return summary

    # ------------------------------------------------------------ helpers —
    def _frame_alphas(self, timestamps: np.ndarray, info: FrameInfo):
        if info.registered_fid <= 1:
            # first frames: collapse timestamps to the end pose
            # (reference odometry.cpp:356-360)
            return np.ones_like(timestamps)
        icp = self.options.ct_icp_options
        if (icp.parametrization == PoseParametrization.SIMPLE
                and not icp.point_to_plane_with_distortion):
            return np.ones_like(timestamps)
        return s3n.alpha_timestamp(timestamps, info.begin_timestamp,
                                   info.end_timestamp)

    def _effective_icp_options(self, info: FrameInfo) -> CTICPOptions:
        """Init-regimen adjusted ICP options (reference odometry.cpp:560-565)."""
        o = self.options
        startup = info.registered_fid < o.init_num_frames
        cached = self._startup_opts_cache.get(startup)
        if cached is None:
            opts = o.ct_icp_options
            if startup:
                opts = dataclasses.replace(
                    opts, threshold_voxel_occupancy=1,
                    num_iters_icp=max(opts.num_iters_icp, 15))
            cached = opts
            self._startup_opts_cache[startup] = cached
        return cached

    def _compute_summary_metrics(self, summary: RegistrationSummary, k: int):
        """Reference ComputeSummaryMetrics (odometry.cpp:978-988)."""
        if k > 0:
            cur, prev = self.trajectory[k], self.trajectory[k - 1]
            summary.distance_correction = float(np.linalg.norm(
                cur.begin_pose.tr - prev.end_pose.tr))
            summary.relative_orientation = prev.end_pose.angular_distance(
                cur.end_pose)
            summary.relative_distance = float(np.linalg.norm(
                prev.end_pose.tr - cur.end_pose.tr))
            summary.ego_orientation = cur.ego_angular_distance()
