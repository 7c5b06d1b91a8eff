"""The odometry driver — host side around the device pipeline.

Counterpart of ``ct_icp_tpu/odometry/odometry.py::Odometry`` on the GRID
keypoint path:
  * ``prepare_frame`` (shuffle, exact host voxel dedup on the wire-quantized
    coords, keypoint-prefix partition, u16 wire packing; with
    ``host_subsample=False`` only the packing of the raw scan, which the
    frame step then sub-samples on the device, kernel K4);
  * ``register_frame`` / ``register_frame_prepared``: one frame at a time,
    the pose initialization on the host (reference InitializeMotion), one
    frame step per attempt; with ``robust_registration`` the escalation
    regimen (reference RobustRegistration + IncreaseRobustnessLevel): each
    attempt's insert is gated on the device by the robust assessment, the
    host assesses in float64 and escalates, and a deferred map update
    resolves the corners the device cannot see;
  * ``stream_frames(preps, batch)``: batches of frames with the map and the
    motion state resident on the device and one readback per batch; robust
    profiles stream speculatively (2-deep), with a checkpoint per batch,
    prefix commit, rollback and per-frame replay;
  * a floating map origin: device coordinates are relative to
    ``self.origin`` (float64, host); when a frame ends farther than
    ``rebase_distance`` from it, the map (and the streaming state) is
    rebased by the float64 shift, sent to the device as float32
    (``pipeline.make_rebase_fn``: kernels K7 and K6), and the origin
    advances by it. The speculative streamer defers the rebase until no
    later batch is in flight (its "rebase" / "levelchange_rebase"
    statuses).

Inserted frames are retained in a host frame ring
(``mapping/frame_ring.py``, ``map_options.max_frames_to_keep`` frames, the
raw scan and the poses) on every path. ``replay_refined_frames`` evicts the
voxels of retained frames' old world points (kernel K9) and re-inserts them
at refined poses (K3); ``get_map_points`` exports a level's points with
refit normals (K10).

The CT-BA backend (``odometry/backend.py``) attaches when
``options.backend.enabled``: it registers a FINISHED_REGISTRATION callback,
which every path fires once for each frame it keeps: the streamer after a
frame's bookkeeping (and rebase), with the frame's keypoint prefix
reconstructed on the host (``_host_keypoints``; as in the reference, also
for a frame of a speculative batch at an escalated robust level, whose
solver elected its keypoints on the device instead); the per-frame paths
with the keypoints the kept attempt's frame step used. A speculative
frame that is rolled back fires nothing; its replay through the per-frame
path fires once.

The solver's search follows the options: the ball neighbourhood, the
exact k-NN (``ball_neighborhood=False``, kernel K12) and the distance
strategy (``options.distance_strategy``: a radius a keypoint and the normal
filter). Where the solver reads the per-voxel normals, every insert keeps
them (the frame step's, the deferred update's and the replay's), and
``get_map_points`` exports them as they are.

The keypoint samplers other than GRID (``sampling`` ADAPTIVE, NONE) and the
random keypoint cap (``max_num_keypoints > 0``) run on the staged per-frame
path, as in the reference, whose fused frame step refuses them
(``_fused_available``): ``register_frame`` -> ``_initialize_frame`` (the
random cut to ``max_scan_points``, the raw scan's sub-sample through K4)
-> ``_try_register`` per attempt (the keypoints: GRID through K4, ADAPTIVE
through K13, NONE the sub-frame's first rows; the random cap; then
``CTICPRegistration.register_device``), or the staged
``_robust_registration`` on a robust profile -> ``_update_map_host`` (the
insertion tracker or the robust decision, then the deferred map update).
It reads its results back each frame; ``stream_frames`` refuses it.

The CONSTANT_VELOCITY motion compensation bends each sub-frame by the
frame's initial poses before its keypoints are elected (the frame core's
``distort_constant_velocity``; on the staged path ``_initialize_frame``
past frame 1), so ``prepare_frame`` elects no host keypoint prefix there:
the device election runs. ``profile_registration`` fills the ICPSummary
phase durations: the staged path registers through
``CTICPRegistration.register_profiled``; the per-frame frame step commits
its own result and then replays the same solver loop with a
``solver.PhaseTimer`` on a copy of the searched level taken before the
insert (``_profile_replay``; the replay's pose difference is logged as
``profile_replay_pose_diff_m``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ct_icp_torch import resolve_device
from ct_icp_torch.config.options import (CTICPOptions, Initialization,
                                         MotionCompensation,
                                         MotionModelOptions, OdometryOptions,
                                         PoseParametrization, SamplingOption)
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.pose import Pose, TrajectoryFrame
from ct_icp_torch.icp.registration import (CTICPRegistration, ICPSummary,
                                           make_prior)
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.mapping.frame_ring import FrameRing
from ct_icp_torch.odometry import pipeline as pl
from ct_icp_torch.odometry.motion_model import PreviousFrameMotionModel
from ct_icp_torch.ops import sampling as smp

# Map-prune cadence (frames); the reference prunes every frame, at 100 m
# thresholds a few frames of lag is behaviorally free.
PRUNE_PERIOD = 8

# The device's float32 insert gate is kept strictly tighter than the host's
# float64 assessment: a threshold tie must resolve to "the device skipped,
# the host decides" — an insert the host would reject cannot be undone.
GATE_MARGIN = 1.0 - 1e-4


@dataclasses.dataclass
class FrameInfo:
    """Reference Odometry::FrameInfo (odometry.h:201-205)."""

    registered_fid: int = -1
    frame_id: int = -1
    begin_timestamp: float = -1.0
    end_timestamp: float = -1.0


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
    # the staged path's corrected sub-frame (world, valid), on the device
    corrected_points: Optional[tuple] = None
    # the solver's keypoints (raw, alphas, valid): numpy arrays, or tensors
    # on the device where the frame step elected them there
    keypoints: Optional[tuple] = None


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


def _unique_voxels(coords: np.ndarray) -> np.ndarray:
    """``np.unique(coords, axis=0)`` of int32 voxel coords [N, 3]: the
    distinct rows in lexicographic order. Within +/-2^20 voxels per axis
    each row packs, offset to be non-negative, into one int64 key in the
    same order, and a 1-D unique of the keys replaces the row unique (a
    sort of a void view), which took most of the host half of a replay of
    60,000-point frames (PERF.md §6, PR 9)."""
    half = 1 << 20
    if coords.shape[0] == 0 or np.abs(coords).max() >= half:
        return np.unique(coords, axis=0)
    b = coords.astype(np.int64) + half
    u = np.unique((b[:, 0] << 42) | (b[:, 1] << 21) | b[:, 2])
    return np.stack([u >> 42, (u >> 21) & 0x1FFFFF, u & 0x1FFFFF],
                    axis=1).astype(np.int32) - np.int32(half)


def _pad_pow2(arr: np.ndarray) -> np.ndarray:
    """``arr`` padded with zero rows to the next power of two rows (at
    least 1): the reference's replay rungs."""
    n = max(arr.shape[0], 1)
    m = 1 << (n - 1).bit_length()
    pad = np.zeros((m - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _escalate_once(opts: CTICPOptions, base_sample_voxel: float,
                   min_voxel: float):
    """One IncreaseRobustnessLevel rung (reference odometry.cpp:996-1018):
    returns (escalated options, escalated sample voxel). The sample voxel
    does not compound: every level >= 1 samples at base/1.5."""
    return dataclasses.replace(
        opts,
        ls_max_num_iters=opts.ls_max_num_iters + 30,
        max_num_residuals=(opts.max_num_residuals * 2
                           if opts.max_num_residuals > 0
                           else opts.max_num_residuals),
        num_iters_icp=min(opts.num_iters_icp + 20, 50),
        threshold_orientation_norm=max(
            opts.threshold_orientation_norm / 10, 1e-5),
        threshold_translation_norm=max(
            opts.threshold_orientation_norm / 10, 1e-4),
        ls_sigma=opts.ls_sigma * 1.2,
        max_dist_to_plane_ct_icp=opts.max_dist_to_plane_ct_icp * 1.5,
    ), max(base_sample_voxel / 1.5, min_voxel)


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


def _zero_motion_model() -> MotionModelOptions:
    return dataclasses.replace(
        MotionModelOptions(), beta_location_consistency=0.0,
        beta_constant_velocity=0.0, beta_small_velocity=0.0,
        beta_orientation_consistency=0.0)


class Odometry:
    """Continuous-time LiDAR odometry against a local voxel map on the card
    (``device="cuda"``, the default) or, for tests, the CPU."""

    def __init__(self, options: OdometryOptions, device=None, seed: int = 0):
        options = _apply_motion_compensation(options)
        self.device = resolve_device(device)
        self.options = options
        self.map_options = options.map_options
        self.map_state = vm.make_map(self.map_options, self.device)
        self.origin = np.zeros(3, dtype=np.float64)
        self.rebase_distance = 500.0
        self.rebases = 0
        self._rebase = pl.make_rebase_fn(self.map_options)
        self._stream_rebase = pl.make_stream_rebase_fn(self.map_options)
        self.registration = CTICPRegistration(
            options.ct_icp_options, self.map_options,
            num_keypoints=options.max_keypoints,
            distance_strategy=options.distance_strategy)
        statics = self.registration.statics
        # the fused frame step takes the GRID keypoints without the random
        # cap; the other samplers run on the staged per-frame path
        # (reference odometry.py:193-201)
        self._fused_available = (options.sampling == SamplingOption.GRID
                                 and options.max_num_keypoints <= 0)
        self._use_fused = (not options.robust_registration
                           and self._fused_available)
        sub = options.max_subsampled_points
        # the per-voxel normals, kept by every insert where the solver
        # reads them (reference odometry.py:186-188)
        self.with_normals = statics.use_normal_filter
        core_args = dict(host_prededuped=options.host_subsample,
                         max_dirty=options.max_dirty_voxels,
                         distort_constant_velocity=(
                             options.motion_compensation
                             == MotionCompensation.CONSTANT_VELOCITY))
        self._frame_step = pl.make_frame_step(self.map_options, statics, sub,
                                              **core_args)
        stream_args = dict(
            sub_capacity=sub,
            const_velocity=(options.initialization
                            == Initialization.INIT_CONSTANT_VELOCITY),
            continuous=(options.motion_compensation
                        == MotionCompensation.CONTINUOUS),
            always_insert=options.always_insert,
            do_no_insert=options.do_no_insert,
            robust_gated=options.robust_registration, **core_args)
        self._multi_step = pl.make_multi_step(pl.make_stream_body(
            self.map_options, statics, **stream_args))
        self._odo_state = torch.as_tensor(pl.init_odo_state(),
                                          device=self.device)
        self._startup_opts_cache = {}
        self.default_motion_model = PreviousFrameMotionModel(
            options.default_motion_model)
        self.trajectory: List[TrajectoryFrame] = []
        self.registered_frames = 0
        self.robust_num_consecutive_failures = 0
        self.suspect_registration_error = False
        self.next_robust_level = options.robust_minimal_level
        self.insertion_tracker = _InsertionTracker()
        # the robust streamer: steady batches committed whole, by dispatched
        # level; mid-batch violations whose steady prefix was committed; and
        # batches rolled back to their checkpoint (prefix commits included)
        self.speculative_batches_committed: Dict[int, int] = {}
        self.speculative_prefix_commits = 0
        self.speculative_rollbacks = 0
        self.rng = np.random.default_rng(seed)
        # a cadence prune that could not run (a robust attempt failed its
        # on-device assessment, so the gated prune was skipped) is owed to
        # the next frame that can prune safely
        self._prune_owed = False
        # device->host reads: the solver's (one per ICP iteration) and the
        # readbacks of frame results (one per attempt or per batch)
        self.host_syncs = 0
        self.result_reads = 0
        # one record a replay: frames, points inserted and evicted, host ms
        self.replay_stats: List[dict] = []
        self.callbacks: Dict[str, list] = {}
        # the last max_frames_to_keep inserted frames (reference map.h:124,
        # 246-253): the replay and export surface
        self.frame_ring = FrameRing(self.map_options.max_frames_to_keep)
        # streamed frames' scans and keypoint prefixes until their results
        # are read: fid -> (xyz, timestamps) and fid -> (kp_n, xyz, alphas)
        self._pending_scans: Dict[int, tuple] = {}
        # streamed frames' (world, world_valid) awaiting their finish
        self._pending_worlds: Dict[int, tuple] = {}
        self._pending_kp: Dict[int, tuple] = {}
        # the sliding-window CT-BA backend, attached last: it registers a
        # FINISHED_REGISTRATION callback
        self.backend = None
        if options.backend.enabled:
            from ct_icp_torch.odometry.backend import CTBABackend
            b = options.backend
            if self.frame_ring.max_frames < b.window:
                # replay needs the ring to still hold the refined frames
                self.frame_ring = FrameRing(b.window)
            self.backend = CTBABackend(
                self, window=b.window, period=b.period,
                num_steps=b.num_steps, keep_first_frames=b.keep_first_frames,
                replay=b.replay, prior_weight=b.prior_weight,
                continuity_beta=b.continuity_beta)

    # ------------------------------------------------------------- public API —
    def map_size(self) -> int:
        return int(self.map_state[0].num_points[0])

    def get_trajectory(self) -> List[TrajectoryFrame]:
        if self.backend is not None:
            self.backend.flush()   # apply a deferred refinement window
        return [f.copy() for f in self.trajectory]

    # callback events (reference OdometryCallback, odometry.h:207-224): the
    # staged path fires the two per-attempt events with its keypoints
    BEFORE_ITERATION = "BEFORE_ITERATION"
    ITERATION_COMPLETED = "ITERATION_COMPLETED"
    FINISHED_REGISTRATION = "FINISHED_REGISTRATION"

    def register_callback(self, event: str, callback):
        """callback(odometry, summary, keypoints_or_None) -> bool."""
        self.callbacks.setdefault(event, []).append(callback)

    def _fire_callbacks(self, event: str, summary, keypoints=None):
        for cb in self.callbacks.get(event, []):
            if cb(self, summary, keypoints) is False:
                raise RuntimeError("Callback returned false")

    def replay_refined_frames(self, refined_frames) -> int:
        """Propagate refined poses into the map (reference
        odometry.py:486-583): re-point the retained frames at
        ``refined_frames`` (matched by the end pose's frame id), empty on
        every level the voxels of their OLD world points (the host-deduped
        union, padded to a power of two; kernel K9, one launch over the
        levels), and re-insert each refined frame's world points,
        host-deduped at ``voxel_size``, with
        the refill budget of 12 election rounds (K3). Without it the next
        inserts wash a refinement out of the map. Returns the points
        re-inserted: summed on the device and read once a replay (with the
        points evicted, kept in ``replay_stats``). One pinned upload carries
        every level's coordinates and every frame's points. Where the
        solver reads the normals (``with_normals``), each re-insert keeps
        them, oriented toward the refined frame's begin translation, as the
        reference's does (one host sync an insert, counted)."""
        t0 = time.perf_counter()
        prep = self._replay_inputs(refined_frames)
        if prep is None:
            return 0
        n_frames, host, counts = prep
        inserted, evicted = self._replay_apply(
            pl.upload(host, self.device), counts)
        ins, ev = torch.cat([inserted, evicted]).tolist()
        self.host_syncs += 1
        self.replay_stats.append({
            "frames": n_frames, "inserted": ins, "evicted": ev,
            "host_ms": (time.perf_counter() - t0) * 1e3})
        return ins

    def _replay_inputs(self, refined_frames):
        """The host half of a replay: re-point the ring, and the arrays the
        device half needs (one a level: the old points' voxel coordinates,
        int32 [M, 3]; one a refined frame: its host-deduped world points,
        f32 [N, 3]; each padded to a power of two) with their true row
        counts; then the refined frames' begin translations, f32 [F, 3].
        None when the ring holds none of ``refined_frames``."""
        ring = self.frame_ring
        if not ring.enabled:
            return None
        by_id = {}
        for f in refined_frames:
            fid = f.end_pose.frame_id
            if fid is not None and fid >= 0:
                by_id[int(fid)] = f
        fids = [fid for fid in ring.frame_ids() if fid in by_id]
        if not fids:
            return None
        # the OLD-pose world points (the ring still holds the old poses)
        old_local = np.concatenate(
            [ring.get_frame(fid)["world"] for fid in fids], axis=0) \
            - self.origin
        ring.update_trajectory(refined_frames)
        host, counts = [], []
        for rp in self.map_options.resolutions:
            coords = _unique_voxels(np.trunc(
                old_local / rp.resolution).astype(np.int32))
            host.append(_pad_pow2(coords))
            counts.append(coords.shape[0])
        for fid in fids:
            w = ring.get_frame(fid)["world"] - self.origin
            keep = _host_voxel_dedup(w, self.options.voxel_size, w.shape[0])
            w = np.asarray(w[keep], np.float32)
            host.append(_pad_pow2(w))
            counts.append(w.shape[0])
        host.append(np.asarray(
            [ring.get_frame(fid, world=False)["begin_pose"].tr - self.origin
             for fid in fids], np.float32))
        return len(fids), host, counts

    def _replay_apply(self, arrays, counts):
        """The device half of a replay, on the arrays of
        :meth:`_replay_inputs` on the device: one K9 launch evicts every
        level's coordinates (their row counts passed as they are), then one
        K3 insert a refined frame and level (12 election rounds; with the
        normals refit toward the frame's begin translation where the solver
        reads them). Returns (points inserted, points evicted), int32[1]
        each on the device; reads nothing back but the dirty lists'
        lengths of a ``with_normals`` insert."""
        n_lv = len(self.map_state)
        evicted = vm.evict_levels(self.map_state, arrays[:n_lv],
                                  counts[:n_lv])[n_lv:]
        frames = arrays[n_lv:len(counts)]
        begin_trs = arrays[len(counts)]
        valid = [torch.arange(a.shape[0], device=self.device) < n
                 for a, n in zip(frames, counts[n_lv:])]
        inserted = torch.zeros(1, dtype=torch.int32, device=self.device)
        for level, rp in zip(self.map_state, self.map_options.resolutions):
            for f, (w, wv) in enumerate(zip(frames, valid)):
                n_ins, syncs = pl.insert_world(
                    level, w, wv, rp.resolution,
                    rp.min_distance_between_points, 12, self.with_normals,
                    begin_trs[f], self.options.max_dirty_voxels)
                inserted = inserted + n_ins
                self.host_syncs += syncs
        return inserted, evicted

    def get_map_points(self, level: int = 0) -> np.ndarray:
        """World points and normals of one map level, [N, 6] float64, in
        the reference's order (slot, then point; reference GetMapPoints,
        map.h:354-380, odometry.py:1264-1290). The normals of the occupied
        slots are refit for the export (K10, oriented toward the last
        frame's end position) into new tensors, the map's own left alone.
        The points are compacted on the device and copied to the host
        once."""
        lvl = self.map_state[level]
        slots = vm.occupied_slots(lvl)
        idx = slots.long()
        if self.registration.statics.use_normal_filter:
            normals = lvl.normals[idx]
        else:
            loc = (self.trajectory[-1].end_pose.tr - self.origin
                   if self.trajectory else np.zeros(3))
            normals, _ = vm.refit_normals(lvl, torch.as_tensor(
                loc, dtype=torch.float32, device=self.device), slots)
        p = lvl.max_points
        rows = lvl.points[idx].view(-1, 3, p)
        in_cap = (torch.arange(p, device=rows.device)[None, :]
                  < lvl.count[idx][:, None])
        si, j = torch.nonzero(in_cap, as_tuple=True)
        pn = torch.cat([rows[si, :, j], normals[si]], dim=1)
        pn = pn.cpu().numpy().astype(np.float64)
        pn[:, 0:3] += self.origin
        return pn

    def get_visible_map_points(self, view_point: np.ndarray,
                               level: int = 0) -> np.ndarray:
        """The map points whose normal faces ``view_point``: normal .
        (point - view) < 0 (reference GetVisibleMapPoints, map.h:378-407;
        an unoriented normal is a zero vector here and fails the strict
        inequality, as it is skipped there). Through ``get_map_points``
        (K10)."""
        pn = self.get_map_points(level)
        scal = np.sum(pn[:, 3:6] * (pn[:, 0:3] - np.asarray(view_point)),
                      axis=1)
        return pn[scal < 0.0]

    def reset(self, options: Optional[OdometryOptions] = None):
        """Reference Odometry::Reset (odometry.cpp:956-975): an empty map
        at the origin, no trajectory, the frame ring cleared."""
        if options is not None:
            self.__init__(options, device=self.device)
            return
        self.map_state = vm.make_map(self.map_options, self.device)
        self.origin = np.zeros(3, dtype=np.float64)
        self._odo_state = torch.as_tensor(pl.init_odo_state(),
                                          device=self.device)
        self.trajectory = []
        self.registered_frames = 0
        self.robust_num_consecutive_failures = 0
        self.suspect_registration_error = False
        self.next_robust_level = self.options.robust_minimal_level
        self.insertion_tracker = _InsertionTracker()
        self.frame_ring.clear()
        self._pending_scans.clear()
        self._pending_worlds.clear()
        self._pending_kp.clear()
        self._prune_owed = False
        self.default_motion_model.reset()

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
        n = xyz.shape[0]
        if n > self.options.max_scan_points:
            sel = np.random.default_rng(registered_fid).choice(
                n, self.options.max_scan_points, replace=False)
            xyz, timestamps = xyz[sel], timestamps[sel]
        out = self._dedup_and_pack(xyz, timestamps, info)
        out["info"] = info
        return out

    def register_frame_prepared(self, prep: dict,
                                initial_estimate: Optional[TrajectoryFrame]
                                = None) -> RegistrationSummary:
        """Register a frame produced by prepare_frame (in order)."""
        t_start = time.time()
        info = prep["info"]
        if info.registered_fid != self.registered_frames:
            raise ValueError("Prepared frames must be registered in order")
        self.registered_frames += 1
        self._initialize_motion(info, initial_estimate)
        summary = self._do_register(prep["xyz"], prep["timestamps"], info,
                                    prep=prep)
        self._record_frame(info, prep["xyz"], prep["timestamps"], summary)
        summary.logged_values["odometry_total"] = (time.time() - t_start) * 1e3
        return summary

    def register_frame(self, xyz: np.ndarray, timestamps: np.ndarray,
                       frame_id: Optional[int] = None,
                       initial_estimate: Optional[TrajectoryFrame] = None
                       ) -> RegistrationSummary:
        """Register one scan (reference RegisterFrame, odometry.cpp:199-273).

        ``xyz`` [N, 3] sensor-frame points, ``timestamps`` [N] raw per-point
        timestamps (any monotone unit)."""
        t_start = time.time()
        xyz, timestamps = _sanitize_scan(xyz, timestamps)
        info = FrameInfo(
            registered_fid=self.registered_frames,
            frame_id=self.registered_frames if frame_id is None else frame_id,
            begin_timestamp=float(timestamps.min()),
            end_timestamp=float(timestamps.max()))
        self.registered_frames += 1
        self._initialize_motion(info, initial_estimate)
        summary = self._do_register(xyz, timestamps, info)
        self._record_frame(info, xyz, timestamps, summary)
        summary.logged_values["odometry_total"] = (time.time() - t_start) * 1e3
        return summary

    def stream_frames(self, preps, batch: int = 1):
        """Register prepared frames in order (generator of
        RegistrationSummary). ``batch`` frames share one stacked upload and
        one readback of their results; the frames of a batch run one after
        another on the device, and a batch's summaries come after the next
        batch has run. Robust profiles stream speculatively (see
        ``_stream_frames_robust``). A staged profile (a sampler other than
        GRID, or the random keypoint cap) raises: streaming needs the fused
        frame step (reference odometry.py:600-607)."""
        if not self._fused_available:
            raise ValueError(
                "stream_frames needs the fused frame step: sampling=GRID "
                "and max_num_keypoints <= 0; register the frames of a staged "
                "profile with register_frame")
        if self.options.robust_registration:
            yield from self._stream_frames_robust(preps, max(batch, 1))
            return
        def groups():
            group = []
            for prep in preps:
                group.append(prep)
                if len(group) == max(batch, 1):
                    yield group
                    group = []
            if group:
                yield group

        # one batch behind, as the reference reads it: batch k's rows are
        # finished (and a rebase they call for applied to the map and state
        # after batch k + 1) once batch k + 1 has run
        pending = None
        for group in groups():
            # the reference streams a batch of 1, and the frames left over
            # after the last full batch, through its single-frame step,
            # whose summaries carry the corrected points; a full batch's
            # carry none (reference odometry.py:600-605, 759-762)
            cur = self._stream_frames_batched(
                group, keep_world=batch <= 1 or len(group) < batch)
            if pending is not None:
                yield from self._finish_batch(*pending)
            pending = cur
        if pending is not None:
            yield from self._finish_batch(*pending)

    # ------------------------------------------------------ frame preparation —
    def _dedup_and_pack(self, xyz, timestamps, info: FrameInfo) -> dict:
        """Shuffle, voxel dedup, keypoint-prefix partition and wire packing
        of a scan already cut to max_scan_points; without
        ``host_subsample``, the packing of the raw scan alone (reference
        odometry.py:319, :346-349): the frame step sub-samples it on the
        device, in scan order (no shuffle: a time-sorted scan's voxels keep
        their earliest points, as the reference's device path does)."""
        o = self.options
        if not o.host_subsample:
            n = xyz.shape[0]
            alphas = self._frame_alphas(timestamps, info)
            return {
                "n": n,
                "scan_host": pl.pack_scan_u16(
                    xyz, alphas, n, pl.scan_rung(o.max_scan_points, n)),
                "xyz": xyz, "timestamps": timestamps, "alphas": alphas,
                "kp_n": 0, "kp_voxel": 0.0,
            }
        # SHUFFLE before the voxel dedup (reference InitializeFrame,
        # odometry.cpp:349-361): first-per-voxel then draws a random
        # representative per voxel and the keypoint alphas stay uniform
        perm = np.random.default_rng(
            (0x5EED, info.frame_id)).permutation(xyz.shape[0])
        xyz, timestamps = xyz[perm], timestamps[perm]
        startup = info.registered_fid < o.init_num_frames
        v = o.init_voxel_size if startup else o.voxel_size
        q = np.rint(xyz * pl.SCAN_QUANT) / pl.SCAN_QUANT
        keep = _host_voxel_dedup(q, v, o.max_subsampled_points)
        xyz, timestamps = xyz[keep], timestamps[keep]
        n = xyz.shape[0]
        cap = min(o.max_scan_points, o.max_subsampled_points)
        if o.motion_compensation == MotionCompensation.CONSTANT_VELOCITY:
            # the device bends the sub-frame before the keypoint election
            # (reference DistortFrame -> grid sampling, odometry.cpp:367,
            # 538): a prefix elected on the unbent coordinates would part
            # from it, so the device election runs (odometry.py:350-354)
            alphas = self._frame_alphas(timestamps, info)
            return {
                "n": n,
                "scan_host": pl.pack_scan_u16(xyz, alphas, n,
                                              pl.scan_rung(cap, n)),
                "xyz": xyz, "timestamps": timestamps, "alphas": alphas,
                "kp_n": 0, "kp_voxel": 0.0,
            }
        # KEYPOINT PREFIX: stable-partition the deduped scan so the
        # sample-voxel grid winners (first in scan order) come first; the
        # device takes keypoints as that prefix when it samples at this
        # voxel size (a robust escalation shrinks it: the device election
        # runs then)
        v_kp = o.init_sample_voxel_size if startup else o.sample_voxel_size
        q = np.rint(xyz * pl.SCAN_QUANT) / pl.SCAN_QUANT
        kp_first = _host_voxel_dedup(q, v_kp, o.max_keypoints)
        mask = np.zeros(n, bool)
        mask[kp_first] = True
        order = np.concatenate([kp_first, np.nonzero(~mask)[0]])
        xyz, timestamps = xyz[order], timestamps[order]
        alphas = self._frame_alphas(timestamps, info)
        return {
            "n": n,
            "scan_host": pl.pack_scan_u16(xyz, alphas, n,
                                          pl.scan_rung(cap, n)),
            "xyz": xyz, "timestamps": timestamps, "alphas": alphas,
            "kp_n": int(kp_first.shape[0]), "kp_voxel": float(v_kp),
        }

    def _prepare_device_scan(self, xyz, timestamps, info: FrameInfo, prep):
        """The packed scan on the device for the frame step (from ``prep``
        when given, else prepared here as prepare_frame would) -> (scan,
        n, kp_n, kp_voxel, prep)."""
        if prep is None:
            n = xyz.shape[0]
            cap = self.options.max_scan_points
            if n > cap:
                sel = self.rng.choice(n, cap, replace=False)
                xyz, timestamps = xyz[sel], timestamps[sel]
            prep = self._dedup_and_pack(xyz, timestamps, info)
        scan = torch.from_numpy(prep["scan_host"].view(np.int16)).to(
            self.device)
        return (scan, prep["n"], prep.get("kp_n", 0),
                prep.get("kp_voxel", 0.0), prep)

    def _stash_scan(self, prep: dict):
        """Keep a streamed frame's scan (for the frame ring) and keypoint
        prefix (for :meth:`_host_keypoints`) until its insertion outcome is
        read, one batch behind (reference odometry.py:430-439)."""
        fid = prep["info"].registered_fid
        if self.frame_ring.enabled:
            self._pending_scans[fid] = (prep["xyz"], prep["timestamps"])
        if self.callbacks.get(self.FINISHED_REGISTRATION) \
                and prep.get("kp_n", 0) > 0:
            self._pending_kp[fid] = (prep["kp_n"], prep["xyz"],
                                     prep.get("alphas"))

    def _record_frame(self, info: FrameInfo, xyz, timestamps,
                      summary: RegistrationSummary):
        """Retain a per-frame path's frame in the ring if its points were
        inserted (reference odometry.py:474-484; the reference map keeps
        only frames that went through InsertPointCloud)."""
        self._pending_scans.pop(info.registered_fid, None)
        self._pending_kp.pop(info.registered_fid, None)
        if summary.points_added and self.frame_ring.enabled:
            self.frame_ring.push(info.frame_id, xyz, timestamps,
                                 summary.frame)

    def _keypoint_prefix(self, kp_n: int, xyz, alphas, keep=None):
        """The solver's keypoints rebuilt on the host from a prep's prefix
        (reference odometry.py:442-482): the first ``kp_n`` prepared points
        on their wire-quantized coordinates and alphas, then (``keep``) the
        residual-cap decimation's indices, compacted and padded to
        max_keypoints. Returns (raw f32 [K, 3], alphas f32 [K], valid bool
        [K]), or None without alphas."""
        if alphas is None:
            return None
        cap = self.options.max_keypoints
        kp_n = min(int(kp_n), cap)
        q = np.rint(xyz[:kp_n] * pl.SCAN_QUANT) / pl.SCAN_QUANT
        a = np.rint(np.clip(alphas[:kp_n], 0.0, 1.0) * 65535.0) / 65535.0
        if keep is not None:
            q, a = q[keep], a[keep]
        n = q.shape[0]
        raw = np.zeros((cap, 3), np.float32)
        raw[:n] = q
        al = np.zeros((cap,), np.float32)
        al[:n] = a
        valid = np.zeros((cap,), bool)
        valid[:n] = True
        return raw, al, valid

    def _host_keypoints(self, k: int):
        """The keypoints of streamed frame ``k``, rebuilt on the host with
        no device read. Exact by construction of the keypoint-prefix path:
        prepare_frame stable-partitions the deduped scan so the sample-grid
        winners are the first kp_n rows, and the streamed frame takes its
        keypoints as that prefix (frame scalar fs[16]). Returns the
        (raw, alphas, valid) of :meth:`_keypoint_prefix`, or None when no
        prefix was stashed."""
        kp_info = self._pending_kp.pop(k, None)
        if kp_info is None:
            return None
        return self._keypoint_prefix(*kp_info)

    # ------------------------------------------------------------ motion init —
    def _initialize_motion(self, info: FrameInfo,
                           initial_estimate: Optional[TrajectoryFrame]):
        """Reference InitializeMotion (odometry.cpp:276-330)."""
        if initial_estimate is not None:
            self.trajectory.append(initial_estimate.copy())
            return
        k = info.registered_fid
        frame = TrajectoryFrame(
            Pose(timestamp=info.begin_timestamp, frame_id=info.frame_id),
            Pose(timestamp=info.end_timestamp, frame_id=info.frame_id))
        tr = self.trajectory
        const_vel = (self.options.initialization
                     == Initialization.INIT_CONSTANT_VELOCITY)
        continuous = (self.options.motion_compensation
                      == MotionCompensation.CONTINUOUS)
        if k <= 1:
            pass  # identity
        elif k == 2:
            if const_vel:
                rel = tr[k - 2].end_pose.inverse() * tr[k - 1].end_pose
                frame.begin_pose.quat = tr[k - 1].end_pose.quat.copy()
                frame.begin_pose.tr = tr[k - 1].end_pose.tr.copy()
                nxt = tr[k - 1].end_pose * rel
                frame.end_pose.quat, frame.end_pose.tr = nxt.quat, nxt.tr
            else:
                frame.begin_pose.quat = tr[k - 1].begin_pose.quat.copy()
                frame.begin_pose.tr = tr[k - 1].begin_pose.tr.copy()
                frame.end_pose.quat = frame.begin_pose.quat.copy()
                frame.end_pose.tr = frame.begin_pose.tr.copy()
        else:
            if const_vel:
                if continuous:
                    rel_b = (tr[k - 2].begin_pose.inverse()
                             * tr[k - 1].begin_pose)
                    nb = tr[k - 1].begin_pose * rel_b
                    frame.begin_pose.quat, frame.begin_pose.tr = nb.quat, nb.tr
                else:
                    frame.begin_pose.quat = tr[k - 1].end_pose.quat.copy()
                    frame.begin_pose.tr = tr[k - 1].end_pose.tr.copy()
                rel_e = tr[k - 2].end_pose.inverse() * tr[k - 1].end_pose
                ne = tr[k - 1].end_pose * rel_e
                frame.end_pose.quat, frame.end_pose.tr = ne.quat, ne.tr
            else:
                frame.begin_pose.quat = tr[k - 1].end_pose.quat.copy()
                frame.begin_pose.tr = tr[k - 1].end_pose.tr.copy()
                frame.end_pose.quat = frame.begin_pose.quat.copy()
                frame.end_pose.tr = frame.begin_pose.tr.copy()
        self.trajectory.append(frame)

    # ---------------------------------------------------- per-frame registration —
    def _do_register(self, xyz, timestamps, info: FrameInfo,
                     prep=None) -> RegistrationSummary:
        """Reference DoRegister (odometry.cpp:386-501): one frame step, the
        robust regimen on frame steps, or the staged path."""
        if self._use_fused:
            return self._do_register_fused(xyz, timestamps, info, prep=prep)
        if self._fused_available:
            return self._do_register_robust_fused(xyz, timestamps, info,
                                                  prep=prep)
        return self._do_register_staged(xyz, timestamps, info)

    def _prior(self, k: int) -> np.ndarray:
        """The packed motion prior of frame k (registration.make_prior)."""
        o = self.options
        if k == 0:
            return make_prior(None, None, self.origin)
        if o.with_default_motion_model:
            self.default_motion_model.options = o.default_motion_model
            self.default_motion_model.update_state(self.trajectory[k - 1],
                                                   k - 1)
            return self.default_motion_model.device_prior(self.origin)
        return make_prior(self.trajectory[k - 1], _zero_motion_model(),
                          self.origin)

    def _pose_init_packed(self, frame: TrajectoryFrame) -> np.ndarray:
        return np.concatenate([
            s3n.quat_normalize(frame.begin_pose.quat),
            frame.begin_pose.tr - self.origin,
            s3n.quat_normalize(frame.end_pose.quat),
            frame.end_pose.tr - self.origin]).astype(np.float32)

    def _run_frame_step(self, scan, n, frame, prior, dyn, fs):
        """One frame step on the device and the readback of its result."""
        out = self._frame_step(
            self.map_state, scan, n,
            torch.as_tensor(self._pose_init_packed(frame), device=self.device),
            torch.as_tensor(prior, device=self.device), dyn, fs)
        self.host_syncs += out.host_syncs + 1
        self.result_reads += 1
        return out, out.packed.cpu().numpy().astype(np.float64)

    def _set_frame_poses(self, frame: TrajectoryFrame, r):
        frame.begin_pose.quat = r[0:4]
        frame.begin_pose.tr = r[4:7] + self.origin
        frame.end_pose.quat = r[7:11]
        frame.end_pose.tr = r[11:14] + self.origin
        frame.begin_pose.normalize_()
        frame.end_pose.normalize_()

    def _do_register_fused(self, xyz, timestamps, info: FrameInfo,
                           prep=None) -> RegistrationSummary:
        """One frame step (reference _do_register_fused): frame 0 and the
        non-robust per-frame path."""
        o = self.options
        k = info.registered_fid
        t_frame_start = time.time()
        scan, n, kp_n, kp_voxel, prep = self._prepare_device_scan(
            xyz, timestamps, info, prep)
        frame = self.trajectory[k]
        summary = RegistrationSummary()
        summary.initial_frame = frame.copy()
        startup = k < o.init_num_frames
        dyn = self.registration.dynamics(self._effective_icp_options(info))
        tracker = self.insertion_tracker
        force_insert = 0.0
        if o.always_insert or tracker.total_insertions == 0:
            force_insert = 1.0
        if o.do_no_insert:
            force_insert = -1.0
        fs1 = o.init_sample_voxel_size if startup else o.sample_voxel_size
        fs = np.asarray([
            o.init_voxel_size if startup else o.voxel_size,
            fs1,
            o.max_distance,
            1.0 if k > 0 else 0.0,
            force_insert,
            o.insertion_ego_rotation_threshold,
            float(tracker.skipped_frames),
            o.insertion_threshold_frames_skipped,
            o.distance_error_threshold,
            o.orientation_error_threshold,
            1.0 if k % PRUNE_PERIOD == 0 else 0.0,
            np.inf, np.inf, np.inf, 0.0,
            # young-map insert budget (fs[15], see OdometryOptions)
            float(o.bootstrap_insert_rounds) if k < o.bootstrap_frames
            else 4.0,
            self._kp_prefix_scalar(kp_n, kp_voxel, fs1),
        ], dtype=np.float32)
        prior = self._prior(k)
        profile = o.profile_registration and k > 0
        if profile:
            # the searched level before the frame step inserts into it, and
            # the initial poses: the replay's inputs
            level_before = vm.MapLevel(*(
                t.clone() for t in self.map_state[
                    self.registration.level_index]))
            pose_init = self._pose_init_packed(frame)
        _out, r = self._run_frame_step(scan, n, frame, prior, dyn, fs)
        self._set_frame_poses(frame, r)
        summary.frame = frame
        # the corrected sub-frame stays on the device (reference
        # odometry.py:1948): read back only by a consumer that asks
        summary.corrected_points = (_out.world, _out.world_valid)
        self._fill_summary(summary, r)
        summary.points_added = bool(r[21])
        summary.logged_values["odometry_num_subsampled"] = int(r[18])
        summary.logged_values["map_inserted_points"] = int(r[20])
        self._compute_summary_metrics(summary, k)
        assess_ok = bool(r[22])
        summary.success = bool(r[17]) and (assess_ok or k == 0)
        if not summary.success and not assess_ok:
            summary.error_message = "Registration assessment failed"
        tracker.cum_orientation_change_since_insertion += \
            summary.relative_orientation
        tracker.cum_distance_since_insertion += summary.relative_distance
        if summary.points_added:
            tracker.insert_frame(k)
        else:
            tracker.skip_frame()
        if profile:
            self._profile_replay(summary, level_before, _out.keypoints,
                                 pose_init, prior, dyn, r, t_frame_start)
            del level_before
            self._log_summary(summary)
        self._maybe_rebase()
        if self.callbacks.get(self.FINISHED_REGISTRATION):
            # the keypoints the frame step solved with: the prefix after
            # the residual-cap decimation (the reference hands over its
            # device arrays; they are the same points), or the device
            # election's where it ran
            summary.keypoints = _out.keypoints
            kp_prefix = self._kp_prefix_scalar(kp_n, kp_voxel, fs1)
            if kp_prefix > 0:
                cnt = min(int(kp_prefix), o.max_keypoints)
                summary.keypoints = self._keypoint_prefix(
                    cnt, prep["xyz"], prep.get("alphas"),
                    pl.decimation_indices(
                        cnt, int(dyn[pl._MNR_INDEX])))
        self._fire_callbacks(self.FINISHED_REGISTRATION, summary)
        return summary

    def _profile_replay(self, summary: RegistrationSummary, level_before,
                        keypoints, pose_init, prior, dyn, r, t_frame_start):
        """The ICPSummary phase durations of a profiled frame step
        (reference odometry.py:1810-1853). The committed estimate is the
        frame step's; the durations come from a replay of the same solver
        loop with a ``solver.PhaseTimer`` on the inputs the frame step's
        solver saw: its keypoints after the residual-cap decimation, the
        initial poses, prior and dynamics, and the searched level as it was
        before the insert. The replay's largest translation difference to
        the committed poses is logged (``profile_replay_pose_diff_m``; the
        kernels repeat bit for bit, so 0)."""
        from ct_icp_torch.icp.registration import fill_durations
        from ct_icp_torch.icp.solver import PhaseTimer
        icp = summary.icp_summary
        dev = self.device
        timer = PhaseTimer(dev)
        pose = torch.as_tensor(pose_init, device=dev)
        res = self.registration.register_fn(
            level_before, *keypoints, pose[0:4], pose[4:7], pose[7:11],
            pose[11:14], torch.as_tensor(prior, device=dev), dyn,
            timer=timer)
        tr = torch.cat([res.tr_begin, res.tr_end]).cpu().numpy()
        self.host_syncs += res.host_syncs + 1
        fill_durations(icp, timer, res.num_iters)
        icp.duration_total = (time.time() - t_frame_start) * 1000.0
        pose_diff = max(float(np.linalg.norm(tr[0:3] - r[4:7])),
                        float(np.linalg.norm(tr[3:6] - r[11:14])))
        summary.logged_values["profile_replay_pose_diff_m"] = pose_diff
        summary.logged_values["profile_replay_num_iters"] = res.num_iters

    @staticmethod
    def _fill_summary(summary: RegistrationSummary, r):
        summary.number_of_residuals = int(r[14])
        summary.sample_size = int(r[19])
        summary.icp_summary.num_residuals_used = int(r[14])
        summary.icp_summary.num_iters = int(r[15])
        summary.icp_summary.success = bool(r[17])

    def _do_register_robust_fused(self, xyz, timestamps, info: FrameInfo,
                                  prep=None) -> RegistrationSummary:
        """The robust regimen through the frame step: one step per attempt
        (its insert applied on the device when the attempt passes the
        device's robust assessment), host escalation between attempts, the
        deferred map update only for the corners the device cannot see."""
        k = info.registered_fid
        if k == 0:
            # frame 0: no registration, insert directly
            return self._do_register_fused(xyz, timestamps, info, prep=prep)
        summary = RegistrationSummary()
        summary.frame = self.trajectory[k].copy()
        summary.initial_frame = self.trajectory[k].copy()
        out, inserted, count = self._robust_registration_fused(
            xyz, timestamps, info, summary, self._prior(k), prep=prep)
        self.trajectory[k] = summary.frame
        # the kept attempt's corrected sub-frame, on the device (reference
        # odometry.py:1799)
        summary.corrected_points = (out.world, out.world_valid)
        self._compute_summary_metrics(summary, k)
        self._update_map_host(summary, out.world, out.world_valid, k,
                              device_inserted=inserted,
                              device_inserted_count=count)
        self._maybe_rebase()
        self._fire_callbacks(self.FINISHED_REGISTRATION, summary)
        return summary

    def _robust_registration_fused(self, xyz, timestamps, info: FrameInfo,
                                   summary: RegistrationSummary, prior,
                                   prep=None):
        """Reference RobustRegistration (odometry.cpp:780-852) on the frame
        step. Returns (the last attempt's FrameResult, whether the device
        inserted, how many points). With callbacks registered,
        ``summary.keypoints`` gets the kept (last) attempt's keypoints: the
        host reconstruction of the prefix where it ran on the prefix, its
        device election otherwise (reference odometry.py:1734)."""
        o = self.options
        k = info.registered_fid
        scan, n, kp_n, kp_voxel, prep = self._prepare_device_scan(
            xyz, timestamps, info, prep)
        attempt_opts = self._effective_icp_options(info)
        startup = k < o.init_num_frames
        sample_voxel_size = (o.init_sample_voxel_size if startup
                             else o.sample_voxel_size)
        min_voxel_size = min(o.init_voxel_size, o.voxel_size)
        initial_estimate = summary.frame.copy()
        robust_level = 0
        summary.number_of_attempts = 0

        def increase_level():
            nonlocal attempt_opts, sample_voxel_size, robust_level
            summary.frame = initial_estimate.copy()
            attempt_opts, sample_voxel_size = _escalate_once(
                attempt_opts, o.sample_voxel_size, min_voxel_size)
            robust_level += 1

        for _ in range(self.next_robust_level):
            increase_level()

        summary.points_added = False
        # the device cannot see do_no_insert / always_insert: force the safe
        # side and let the deferred update resolve them
        gate_mode = -1.0 if o.do_no_insert else 2.0
        gm = GATE_MARGIN
        while True:
            summary.robust_level = robust_level
            dyn = self.registration.dynamics(attempt_opts)
            fs = np.asarray([
                o.init_voxel_size if startup else o.voxel_size,
                sample_voxel_size,
                o.max_distance,
                1.0,
                gate_mode,
                o.insertion_ego_rotation_threshold, 0.0,
                o.insertion_threshold_frames_skipped,
                o.distance_error_threshold * gm,
                o.orientation_error_threshold * gm,
                1.0 if (k % PRUNE_PERIOD == 0 or self._prune_owed) else 0.0,
                o.robust_threshold_relative_orientation * gm,
                o.robust_threshold_ego_orientation * gm,
                o.robust_relative_trans_threshold * gm,
                1.0 if (robust_level == 0
                        and o.robust_num_attempts_when_rotation > 0) else 0.0,
                # young-map insert budget (fs[15], see OdometryOptions)
                float(o.bootstrap_insert_rounds) if k < o.bootstrap_frames
                else 4.0,
                self._kp_prefix_scalar(kp_n, kp_voxel, sample_voxel_size),
            ], dtype=np.float32)
            out, r = self._run_frame_step(scan, n, summary.frame, prior, dyn,
                                          fs)
            self._set_frame_poses(summary.frame, r)
            self._fill_summary(summary, r)
            summary.success = bool(r[17])
            summary.number_of_attempts += 1
            inserted_on_device = bool(r[21])
            inserted_count = int(r[20])
            assess_ok_device = bool(r[22])
            if k > 0:
                prev = self.trajectory[k - 1]
                summary.distance_correction = float(np.linalg.norm(
                    summary.frame.begin_pose.tr - prev.end_pose.tr))
                summary.relative_orientation = prev.end_pose.angular_distance(
                    summary.frame.end_pose)
                summary.ego_orientation = summary.frame.ego_angular_distance()
            summary.relative_distance = float(np.linalg.norm(
                summary.frame.end_pose.tr - summary.frame.begin_pose.tr))
            if self._assess_registration(summary):
                break
            if summary.number_of_attempts < o.robust_num_attempts:
                increase_level()
            else:
                break

        if self.callbacks.get(self.FINISHED_REGISTRATION):
            kp_prefix = self._kp_prefix_scalar(kp_n, kp_voxel,
                                               sample_voxel_size)
            summary.keypoints = out.keypoints
            if kp_prefix > 0:
                cnt = min(int(kp_prefix), o.max_keypoints)
                summary.keypoints = self._keypoint_prefix(
                    cnt, prep["xyz"], prep.get("alphas"),
                    pl.decimation_indices(cnt, int(dyn[pl._MNR_INDEX])))
        if summary.number_of_attempts >= o.robust_num_attempts:
            self.robust_num_consecutive_failures += 1
        else:
            self.robust_num_consecutive_failures = 0
        # a requested prune only ran if the final attempt's device
        # assessment passed (the frame core gates the sweep on assess_ok)
        prune_requested = (k % PRUNE_PERIOD == 0) or self._prune_owed
        self._prune_owed = prune_requested and not assess_ok_device
        return out, inserted_on_device, inserted_count

    def _assess_registration(self, summary: RegistrationSummary) -> bool:
        """Reference AssessRegistration (odometry.cpp:604-684)."""
        o = self.options
        if summary.relative_distance > o.distance_error_threshold:
            summary.error_message = "Error in ego-motion distance !"
            return False
        if (summary.relative_orientation > o.orientation_error_threshold
                or summary.ego_orientation > o.orientation_error_threshold):
            summary.error_message = "Error in ego-motion orientation !"
            return False
        success = summary.success
        if o.robust_registration:
            if (summary.robust_level == 0
                    and (summary.relative_orientation
                         > o.robust_threshold_relative_orientation
                         or summary.ego_orientation
                         > o.robust_threshold_ego_orientation)):
                if summary.robust_level < o.robust_num_attempts_when_rotation:
                    summary.error_message = (
                        "Large rotations require at a robust_level of at "
                        f"least 1 (got: {summary.robust_level}).")
                    return False
            if summary.relative_distance > o.robust_relative_trans_threshold:
                summary.error_message = "The relative distance is too important"
                return False
        return success

    # ------------------------------------------------------- the staged path —
    def _cap_scores(self, seed: int, n: int):
        """The random cap's scores: ``n`` uniform draws in [0, 1) from a
        generator on the device seeded with ``seed`` (the reference draws
        ``jax.random.uniform(PRNGKey(seed))``, which gives other numbers from
        the same seed; the CPU tests put the reference's draw here)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return torch.rand(n, generator=g, device=self.device)

    def _initialize_frame(self, xyz, timestamps, info: FrameInfo):
        """The sub-frame of a scan (reference InitializeFrame,
        odometry.cpp:333-382; odometry.py:1390-1418): a random cut to
        ``max_scan_points`` (this odometry's numpy generator, as the
        reference's), then the voxel sub-sample on the device (K4) ->
        (sub_raw, sub_alphas, sub_valid, count). K4 takes the scan's upload
        rung rather than all ``max_scan_points`` rows: the rows past the
        scan are invalid either way, so the sub-frame is the same."""
        o = self.options
        n = xyz.shape[0]
        cap = o.max_scan_points
        if n > cap:
            sel = self.rng.choice(n, cap, replace=False)
            xyz, timestamps = xyz[sel], timestamps[sel]
            n = cap
        rung = pl.scan_rung(cap, n)
        raw = np.zeros((rung, 3), np.float32)
        raw[:n] = xyz
        alphas = np.ones((rung,), np.float32)
        alphas[:n] = self._frame_alphas(timestamps, info)
        valid = np.zeros((rung,), bool)
        valid[:n] = True
        sample_size = (o.init_voxel_size
                       if info.registered_fid < o.init_num_frames
                       else o.voxel_size)
        sub_raw, sub_alphas, sub_valid, cnt = pl.preprocess(
            *pl.upload([raw, alphas, valid], self.device), sample_size,
            o.max_subsampled_points)
        k = info.registered_fid
        if (k > 1 and o.motion_compensation
                == MotionCompensation.CONSTANT_VELOCITY):
            # bent by the frame's initial poses (reference
            # odometry.py:1415-1417)
            pose = torch.as_tensor(
                self._pose_init_packed(self.trajectory[k]),
                device=self.device)
            sub_raw = pl.distort_raw(sub_raw, sub_alphas, pose[0:4],
                                     pose[4:7], pose[7:11], pose[11:14])
        self.host_syncs += 1
        return sub_raw, sub_alphas, sub_valid, int(cnt)

    def _try_register(self, sub, info: FrameInfo, icp_options: CTICPOptions,
                      summary: RegistrationSummary, sample_voxel_size: float,
                      prior):
        """One registration attempt on the sub-frame (reference TryRegister,
        odometry.cpp:525-601; odometry.py:1420-1473): the keypoints (GRID:
        K4; ADAPTIVE: K13; NONE: the first ``max_keypoints`` rows), the
        random cap once past the startup frames, the startup regimen, then
        the solver."""
        o = self.options
        sub_raw, sub_alphas, sub_valid = sub
        is_startup = info.registered_fid < o.init_num_frames
        if o.sampling == SamplingOption.GRID:
            kp_raw, kp_alphas, kp_valid, kp_cnt = pl.sample_keypoints(
                sub_raw, sub_alphas, sub_valid, sample_voxel_size,
                o.max_keypoints)
        elif o.sampling == SamplingOption.ADAPTIVE:
            idx, kp_valid, kp_cnt = smp.adaptive_grid_sampling_indices(
                sub_raw, sub_valid, o.adaptive_options, o.max_keypoints)
            idx = idx.to(torch.int64)
            kp_raw, kp_alphas = sub_raw[idx], sub_alphas[idx]
        else:
            m = o.max_keypoints
            kp_raw, kp_alphas, kp_valid = (sub_raw[:m], sub_alphas[:m],
                                           sub_valid[:m])
            kp_cnt = kp_valid.sum(dtype=torch.int32)

        if not is_startup and o.max_num_keypoints > 0:
            # the random cap (reference shuffle + resize,
            # odometry.cpp:549-552): the draw's seed from this odometry's
            # numpy generator, where the reference takes it
            scores = self._cap_scores(int(self.rng.integers(0, 2 ** 31)),
                                      kp_valid.shape[0])
            idx, kp_valid, _ = smp.random_cap_indices(
                kp_valid, scores, o.max_keypoints, o.max_num_keypoints)
            idx = idx.to(torch.int64)
            kp_raw, kp_alphas = kp_raw[idx], kp_alphas[idx]

        summary.sample_size = int(kp_cnt)
        self.host_syncs += 1
        opts = icp_options
        if is_startup:
            # init regimen (reference odometry.cpp:560-565)
            opts = dataclasses.replace(
                opts, threshold_voxel_occupancy=1,
                num_iters_icp=max(opts.num_iters_icp, 15))
        keypoints = (kp_raw, kp_alphas, kp_valid)
        self._fire_callbacks(self.BEFORE_ITERATION, summary, keypoints)
        reg = (self.registration.register_profiled
               if o.profile_registration
               else self.registration.register_device)
        icp = reg(self.map_state, kp_raw, kp_alphas, kp_valid, summary.frame,
                  prior=prior, origin=self.origin, options=opts)
        self.host_syncs += icp.host_syncs
        self.result_reads += 1
        summary.icp_summary = icp
        summary.success = icp.success
        summary.number_of_residuals = icp.num_residuals_used
        summary.keypoints = keypoints
        self._fire_callbacks(self.ITERATION_COMPLETED, summary, keypoints)
        if not icp.success:
            summary.error_message = icp.error_log

    def _robust_registration(self, sub, info: FrameInfo,
                             summary: RegistrationSummary, prior):
        """Reference RobustRegistration + IncreaseRobustnessLevel on the
        staged path (odometry.cpp:780-852, 996-1018; odometry.py:1500-1551):
        one ``_try_register`` an attempt, escalating between them."""
        o = self.options
        attempt_opts = o.ct_icp_options
        sample_voxel_size = (o.init_sample_voxel_size
                             if info.registered_fid < o.init_num_frames
                             else o.sample_voxel_size)
        robust_level = 0
        initial_estimate = summary.frame.copy()
        summary.number_of_attempts = 0
        min_voxel_size = min(o.init_voxel_size, o.voxel_size)

        def increase_level():
            nonlocal attempt_opts, sample_voxel_size, robust_level
            summary.frame = initial_estimate.copy()
            attempt_opts, sample_voxel_size = _escalate_once(
                attempt_opts, o.sample_voxel_size, min_voxel_size)
            robust_level += 1

        for _ in range(self.next_robust_level):
            increase_level()

        k = info.registered_fid
        while True:
            summary.robust_level = robust_level
            self._try_register(sub, info, attempt_opts, summary,
                               sample_voxel_size, prior)
            summary.number_of_attempts += 1
            if k > 0:
                prev = self.trajectory[k - 1]
                summary.distance_correction = float(np.linalg.norm(
                    summary.frame.begin_pose.tr - prev.end_pose.tr))
                summary.relative_orientation = prev.end_pose.angular_distance(
                    summary.frame.end_pose)
                summary.ego_orientation = summary.frame.ego_angular_distance()
            summary.relative_distance = float(np.linalg.norm(
                summary.frame.end_pose.tr - summary.frame.begin_pose.tr))
            if self._assess_registration(summary):
                break
            if summary.number_of_attempts < o.robust_num_attempts:
                increase_level()
            else:
                break

        if summary.number_of_attempts >= o.robust_num_attempts:
            self.robust_num_consecutive_failures += 1
        else:
            self.robust_num_consecutive_failures = 0

    def _do_register_staged(self, xyz, timestamps,
                            info: FrameInfo) -> RegistrationSummary:
        """Reference DoRegister's staged branch (odometry.py:1980-2031): the
        sub-frame, then (past frame 0) one attempt or the robust regimen,
        the assessment, the corrected sub-frame, the insertion decision and
        the deferred map update. With ``quit_on_error`` a frame that fails
        its assessment returns before the map update, as the reference's
        does."""
        o = self.options
        k = info.registered_fid
        sub_raw, sub_alphas, sub_valid, sub_count = self._initialize_frame(
            xyz, timestamps, info)
        sub = (sub_raw, sub_alphas, sub_valid)
        summary = RegistrationSummary()
        summary.frame = self.trajectory[k].copy()
        summary.initial_frame = self.trajectory[k].copy()
        summary.logged_values["odometry_num_subsampled"] = sub_count

        if k > 0:
            prior = None
            if o.with_default_motion_model:
                self.default_motion_model.options = o.default_motion_model
                self.default_motion_model.update_state(
                    self.trajectory[k - 1], k - 1)
                prior = self.default_motion_model.device_prior(self.origin)
            if o.robust_registration:
                self._robust_registration(sub, info, summary, prior)
            else:
                sample_voxel_size = (o.init_sample_voxel_size
                                     if k < o.init_num_frames
                                     else o.sample_voxel_size)
                self._try_register(sub, info, o.ct_icp_options, summary,
                                   sample_voxel_size, prior)
                prev = self.trajectory[k - 1]
                summary.relative_orientation = prev.end_pose.angular_distance(
                    summary.frame.end_pose)
                summary.ego_orientation = summary.frame.ego_angular_distance()
                summary.relative_distance = float(np.linalg.norm(
                    summary.frame.end_pose.tr - summary.frame.begin_pose.tr))
                if not self._assess_registration(summary):
                    summary.success = False
                    if o.quit_on_error:
                        self.trajectory[k] = summary.frame
                        return summary
            self.trajectory[k] = summary.frame

        # the sub-frame in the world with the optimized poses
        pose = torch.as_tensor(self._pose_init_packed(summary.frame),
                               device=self.device)
        world = pl.transform_points(sub_raw, sub_alphas, pose[0:4],
                                    pose[4:7], pose[7:11], pose[11:14])
        summary.corrected_points = (world, sub_valid)
        self._compute_summary_metrics(summary, k)
        self._update_map_host(summary, world, sub_valid, k)
        self._maybe_rebase()
        self._log_summary(summary)
        self._fire_callbacks(self.FINISHED_REGISTRATION, summary)
        return summary

    def _log_summary(self, summary: RegistrationSummary):
        """Reference LogSummary (odometry.cpp:505-520; odometry.py:2033):
        the ICP phase durations as logged values."""
        icp = summary.icp_summary
        lv = summary.logged_values
        lv["odometry_num_keypoints"] = float(summary.sample_size)
        lv["icp_duration_neighborhood"] = (icp.avg_duration_neighborhood
                                           * icp.num_iters)
        lv["icp_duration_solve"] = icp.avg_duration_solve * icp.num_iters
        lv["icp_total_duration"] = icp.duration_total
        lv["icp_num_iters"] = float(icp.num_iters)
        if self.options.debug_print:
            print("[CT-ICP] Logged Values:")
            for key in sorted(lv):
                print(f" -- {key}: {lv[key]}")

    def _update_map_host(self, summary: RegistrationSummary, world,
                         world_valid, k: int,
                         device_inserted: Optional[bool] = None,
                         device_inserted_count: int = 0):
        """The insertion decision and the deferred map update (reference
        UpdateMap, odometry.cpp:855-953): the robust decision on robust
        profiles, the insertion tracker's heuristic on the others. On the
        robust frame-step path (``device_inserted`` given) the attempt's
        frame step already ran the robust-gated insert + prune on the
        device; when its decision matches the host's ``add_points`` nothing
        more runs. A mismatch — possible only in corners the device cannot
        see (always_insert, the consecutive-failure override after attempt
        exhaustion) — runs the deferred update, which the staged path
        (``device_inserted`` None) always runs."""
        o = self.options
        add_points = True
        if o.robust_registration:
            self.suspect_registration_error = (
                summary.number_of_attempts >= o.robust_num_attempts)
            add_points = not (
                summary.ego_orientation > o.robust_threshold_ego_orientation
                or summary.relative_orientation
                > o.robust_threshold_relative_orientation)
            if self.suspect_registration_error:
                add_points |= self.robust_num_consecutive_failures > 5
            self.next_robust_level = (o.robust_minimal_level if add_points
                                      else o.robust_minimal_level + 1)
            if not summary.success:
                self.next_robust_level = o.robust_minimal_level + 2
            elif (summary.relative_orientation
                  > o.robust_threshold_relative_orientation
                  or summary.ego_orientation
                  > o.robust_threshold_ego_orientation
                  or summary.number_of_attempts > 1):
                self.next_robust_level = o.robust_minimal_level + 1
        else:
            tracker = self.insertion_tracker
            tracker.cum_orientation_change_since_insertion += \
                summary.relative_orientation
            tracker.cum_distance_since_insertion += summary.relative_distance
            if (tracker.total_insertions > 0 and summary.ego_orientation
                    > o.insertion_ego_rotation_threshold):
                add_points = (tracker.skipped_frames
                              > o.insertion_threshold_frames_skipped)

        summary.points_added = add_points
        if o.do_no_insert:
            add_points = False
        if o.always_insert:
            add_points = True
        if device_inserted is not None and device_inserted == add_points:
            # the attempt's frame step already applied this decision
            summary.logged_values["map_inserted_points"] = \
                device_inserted_count
        elif device_inserted and not add_points:
            # cannot un-insert; record the divergence (needs an exact tie
            # between the device's float32 and the host's float64 tests)
            summary.logged_values["map_inserted_points"] = \
                device_inserted_count
            summary.logged_values["insertion_divergence"] = 1.0
            add_points = True
        else:
            location = torch.as_tensor(
                self.trajectory[-1].end_pose.tr - self.origin,
                dtype=torch.float32, device=self.device)
            begin_tr = torch.as_tensor(
                summary.frame.begin_pose.tr - self.origin,
                dtype=torch.float32, device=self.device)
            inserted, syncs = pl.update_map(
                self.map_state, self.map_options, world, world_valid,
                location, float(np.float32(o.max_distance)), add_points,
                prune=(k % PRUNE_PERIOD == 0) or self._prune_owed,
                with_normals=self.with_normals, begin_tr=begin_tr,
                max_dirty=o.max_dirty_voxels)
            self._prune_owed = False
            self.result_reads += 1
            self.host_syncs += 1 + syncs
            summary.logged_values["map_inserted_points"] = int(inserted[0])
        if add_points:
            self.insertion_tracker.insert_frame(k)
        else:
            self.insertion_tracker.skip_frame()

    def _strayed(self) -> bool:
        """The last frame ended farther than rebase_distance from the
        origin."""
        return bool(np.linalg.norm(self.trajectory[-1].end_pose.tr
                                   - self.origin) > self.rebase_distance)

    def _shift(self) -> np.ndarray:
        """The float64 shift that moves the origin to the last frame's end
        position."""
        return (self.trajectory[-1].end_pose.tr - self.origin).astype(
            np.float64)

    def _device_shift(self, shift: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(shift, np.float32),
                               device=self.device)

    def _maybe_rebase(self):
        """The per-frame path's floating origin (reference
        odometry.py:2137-2143): past rebase_distance, rebase the map by the
        shift to the last frame's end position."""
        if self._strayed():
            shift = self._shift()
            self.map_state = self._rebase(self.map_state,
                                          self._device_shift(shift))
            self.origin = self.origin + shift
            self.rebases += 1

    def _rebase_stream_head(self):
        """Rebase the map and the streaming odometry state by the shift to
        the last frame's end position (reference odometry.py:865-872 and
        rebase_head, :1187-1195). No batch may be in flight beyond the
        current map and state."""
        shift = self._shift()
        self.map_state, self._odo_state = self._stream_rebase(
            self.map_state, self._odo_state, self._device_shift(shift))
        self.origin = self.origin + shift
        self.rebases += 1

    # ------------------------------------------------------------- streaming —
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
            self._kp_prefix_scalar(prep.get("kp_n", 0),
                                   prep.get("kp_voxel", 0.0), fs1),
        ], dtype=np.float32)

    @staticmethod
    def _kp_prefix_scalar(kp_n: int, kp_voxel: float, fs1: float) -> float:
        """fs[16]: the keypoint-prefix count when the partition was
        computed at this frame's sample voxel size, else 0 (the device
        election runs then)."""
        if kp_n > 0 and abs(kp_voxel - fs1) < 1e-9:
            return float(kp_n)
        return 0.0

    def _upload(self, group):
        """One stacked upload of a group's scans -> (scans [B, R, 4] on the
        device, ns, ks)."""
        rung = max(p["scan_host"].shape[0] for p in group)
        scans = np.zeros((len(group), rung, 4), np.uint16)
        for b, prep in enumerate(group):
            sh = prep["scan_host"]
            scans[b, :sh.shape[0]] = sh
        return (torch.from_numpy(scans.view(np.int16)).to(self.device),
                [p["n"] for p in group],
                [p["info"].registered_fid for p in group])

    def _stream_frames_batched(self, group, keep_world: bool = False):
        """Run one group's frames in order; returns (infos, packed results
        [B, 24] on the device, origin). ``keep_world``: each frame's
        (world, world_valid) device tensors wait for its finish, which hands
        them to its summary."""
        for prep in group:
            if prep["info"].registered_fid != self.registered_frames:
                raise ValueError("Prepared frames must be streamed in order")
            self.registered_frames += 1
            self._stash_scan(prep)
        scans, ns, ks = self._upload(group)
        dyns = [self.registration.dynamics(
            self._effective_icp_options(p["info"])) for p in group]
        fss = [self._frame_scalars(p) for p in group]
        betas = torch.as_tensor(self._betas(), device=self.device)
        self._odo_state, packed, syncs, _, worlds = self._multi_step(
            self.map_state, self._odo_state, scans, ns, ks, betas, dyns, fss)
        self.host_syncs += syncs
        if keep_world:
            for p, world in zip(group, worlds):
                self._pending_worlds[p["info"].registered_fid] = world
        return [p["info"] for p in group], packed, self.origin.copy()

    def _read_rows(self, packed_all):
        self.host_syncs += 1
        self.result_reads += 1
        return packed_all.cpu().numpy().astype(np.float64)

    def _finish_batch(self, infos, packed_all, origin):
        for info, row in zip(infos, self._read_rows(packed_all)):
            yield self._finish_streamed(info, row, origin)

    def _finish_streamed(self, info, r, origin,
                         allow_rebase: bool = True) -> RegistrationSummary:
        """Host bookkeeping of one streamed frame from its packed result,
        computed in the map frame of ``origin`` (the dispatch-time origin):
        the trajectory, the tracker, the frame ring, the rebase and the
        callbacks (reference odometry.py:808-873). ``allow_rebase=False``
        defers the rebase to the caller: the speculative robust streamer
        must not rebase while a later batch is in flight (its checkpoint
        would straddle the change of frame). The summary's
        ``corrected_points`` are the frame's device tensors where its batch
        kept them, else None."""
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
        summary.corrected_points = self._pending_worlds.pop(k, None)
        self._fill_summary(summary, r)
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
        scan = self._pending_scans.pop(k, None)
        if scan is not None and summary.points_added:
            self.frame_ring.push(info.frame_id, scan[0], scan[1], frame)
        if allow_rebase and self._strayed():
            self._rebase_stream_head()
        if self.callbacks.get(self.FINISHED_REGISTRATION):
            summary.keypoints = self._host_keypoints(k)
            self._fire_callbacks(self.FINISHED_REGISTRATION, summary)
        return summary

    # ------------------------------------------------------- robust streaming —
    def _odo_state_from_host(self) -> torch.Tensor:
        """The device odometry state rebuilt from the host trajectory and
        tracker — when the robust streamer enters (or re-enters after a
        rollback) speculative mode."""
        s = np.array(pl.init_odo_state())
        k = self.registered_frames
        if k >= 1:
            f = self.trajectory[k - 1]
            s[0:4] = s3n.quat_normalize(f.begin_pose.quat)
            s[4:7] = f.begin_pose.tr - self.origin
            s[7:11] = s3n.quat_normalize(f.end_pose.quat)
            s[11:14] = f.end_pose.tr - self.origin
        if k >= 2:
            f2 = self.trajectory[k - 2]
            s[14:18] = s3n.quat_normalize(f2.begin_pose.quat)
            s[18:21] = f2.begin_pose.tr - self.origin
            s[21:25] = s3n.quat_normalize(f2.end_pose.quat)
            s[25:28] = f2.end_pose.tr - self.origin
        s[28] = float(k)
        s[29] = float(self.insertion_tracker.skipped_frames)
        s[30] = float(self.insertion_tracker.total_insertions)
        return torch.as_tensor(s.astype(np.float32), device=self.device)

    def _robust_frame_scalars(self, info: FrameInfo, prep: dict,
                              level: int = 0,
                              sample_voxel: Optional[float] = None
                              ) -> np.ndarray:
        """Frame scalars of a speculative robust streamed frame at
        ``level`` (``sample_voxel`` overrides fs[1] on escalated levels).
        The thresholds carry the per-frame attempts' GATE_MARGIN: a
        device/host tie must resolve to a rollback, never to a speculative
        commit the host would have rejected. The rotation check (fs[14])
        applies at robust level 0 only (reference AssessRegistration,
        odometry.cpp:621-631)."""
        o = self.options
        gm = GATE_MARGIN
        startup = info.registered_fid < o.init_num_frames
        fs1 = (sample_voxel if sample_voxel is not None
               else (o.init_sample_voxel_size if startup
                     else o.sample_voxel_size))
        return np.asarray([
            o.init_voxel_size if startup else o.voxel_size,
            fs1,
            o.max_distance, 0.0, 0.0,
            o.insertion_ego_rotation_threshold, 0.0,
            o.insertion_threshold_frames_skipped,
            o.distance_error_threshold * gm,
            o.orientation_error_threshold * gm,
            1.0 if info.registered_fid % PRUNE_PERIOD == 0 else 0.0,
            o.robust_threshold_relative_orientation * gm,
            o.robust_threshold_ego_orientation * gm,
            o.robust_relative_trans_threshold * gm,
            1.0 if (level == 0
                    and o.robust_num_attempts_when_rotation > 0) else 0.0,
            # young-map insert budget (fs[15], see OdometryOptions)
            float(o.bootstrap_insert_rounds)
            if info.registered_fid < o.bootstrap_frames else 4.0,
            self._kp_prefix_scalar(prep.get("kp_n", 0),
                                   prep.get("kp_voxel", 0.0), fs1),
        ], dtype=np.float32)

    def _stream_frames_robust(self, preps, batch: int):
        """Speculative robust streaming (generator); reference
        _stream_frames_robust, odometry.py:941-1257.

        Steady state is accept-on-first-attempt at a persistent robust level
        (the minimal level on open stretches, minimal + 1 through sustained
        rotation), and the attempt's assessment runs on the device. So
        ``batch`` frames run per dispatch AT the current next_robust_level,
        with robust-gated insertion, and "this frame implies staying at the
        dispatched level" licenses the speculation. A frame that breaks it
        ends the committed prefix: the map rolls back to the batch's
        checkpoint, the prefix re-runs with the suffix made map-neutral
        (fs[8] = -1 fails its assessment, which blocks its insert and
        prune), and the suffix replays through the per-frame escalation
        path. Two batches are in flight: batch k+1 is dispatched before
        batch k's rows are read; when k does not commit whole, or commits
        whole but strays past the rebase distance or changes the level,
        k+1's work is discarded (its checkpoint is the post-k state), the
        deferred rebase applied, and k+1 dispatched again. Frames are
        prepared by the caller (``concurrent.PrefetchIterator`` can prepare
        them in worker threads)."""
        o = self.options
        minimal = o.robust_minimal_level
        betas = torch.as_tensor(self._betas(), device=self.device)
        tail = []

        def groups():
            g = []
            for prep in preps:
                g.append(prep)
                if len(g) == batch:
                    yield g
                    g = []
            tail.extend(g)

        # speculation levels: next_robust_level only sits at minimal or
        # minimal + 1 after a passing frame; higher levels need failures,
        # which drain per-frame
        spec_levels = (minimal, minimal + 1)
        min_voxel = min(o.init_voxel_size, o.voxel_size)

        def level_inputs(group, level):
            dyns, fss = [], []
            for prep in group:
                info = prep["info"]
                opts = self._effective_icp_options(info)
                sv = None
                for _ in range(level):
                    opts, sv = _escalate_once(opts, o.sample_voxel_size,
                                              min_voxel)
                dyns.append(self.registration.dynamics(opts))
                fss.append(self._robust_frame_scalars(
                    info, prep, level=level, sample_voxel=sv))
            return dyns, fss

        def stack_upload(group):
            for prep in group:
                self._stash_scan(prep)
            scans, ns, ks = self._upload(group)
            per_level = {lv: level_inputs(group, lv) for lv in spec_levels}
            return group, scans, ns, ks, per_level

        def dispatch(upload):
            """Run one batch at the current next_robust_level from the
            current state, keeping its checkpoint."""
            group, scans, ns, ks, per_level = upload
            level = self.next_robust_level
            dyns, fss = per_level[level]
            self._odo_state, packed, syncs, ckpt, _ = self._multi_step(
                self.map_state, self._odo_state, scans, ns, ks, betas, dyns,
                fss, with_checkpoint=True)
            self.host_syncs += syncs
            return {"upload": upload, "group": group, "level": level,
                    "packed": packed, "ckpt": ckpt}

        def resolve(p):
            """Read one batch's rows; commit the steady prefix, then repair
            and replay the rest. Returns "ok" (whole batch committed),
            "rebase" (whole batch committed, a frame strayed past the rebase
            distance: the caller applies the deferred rebase with no batch
            in flight), "levelchange" / "levelchange_rebase" (whole batch
            committed, its last frame implies a level transition: a batch in
            flight ran at the stale level; plus the deferred rebase) or
            "rolledback" (the committed prefix does not rebase; a replayed
            frame rebases on the per-frame path)."""
            group = p["group"]
            rows = self._read_rows(p["packed"])
            lvl = p["level"]
            pass_ok = (rows[:, 22] > 0) & (rows[:, 17] > 0)
            implied = np.where(rows[:, 23] > 0, minimal, minimal + 1)
            if group[0]["info"].registered_fid == 0:
                pass_ok[0] = True      # frame 0 does not register
                implied[0] = lvl
            # prefix commit: frame i of the batch depends only on frames
            # < i, so every frame before the first violation ran what the
            # per-frame path would have run; a passing frame that implies a
            # level transition is itself committable
            commit_n, new_level = 0, None
            for i in range(len(group)):
                if not pass_ok[i]:
                    break
                commit_n = i + 1
                if implied[i] != lvl:
                    new_level = int(implied[i])
                    break
            origin0 = self.origin.copy()
            for prep, row in zip(group[:commit_n], rows[:commit_n]):
                info = prep["info"]
                self.registered_frames = info.registered_fid + 1
                summary = self._finish_streamed(info, row, origin0,
                                                allow_rebase=False)
                summary.number_of_attempts = 1
                summary.robust_level = lvl
                self.robust_num_consecutive_failures = 0
                self.suspect_registration_error = False
                self.next_robust_level = lvl
                yield summary
            if new_level is not None:
                self.next_robust_level = new_level
            if commit_n == len(group):
                self.speculative_batches_committed[lvl] = \
                    self.speculative_batches_committed.get(lvl, 0) + 1
                # any committed frame past the rebase distance defers the
                # rebase, not only the last one
                ends = np.stack([f.end_pose.tr
                                 for f in self.trajectory[-commit_n:]])
                strayed = bool(np.any(np.linalg.norm(
                    ends - self.origin, axis=1) > self.rebase_distance))
                if new_level is not None:
                    return "levelchange_rebase" if strayed else "levelchange"
                return "rebase" if strayed else "ok"

            # mid-batch violation: roll back, then one re-run from the
            # checkpoint in which the suffix is map-neutral (fs[8] = -1
            # fails its assessment: no insert, no prune) brings the map to
            # the post-prefix state; the suffix's odometry state is
            # discarded (rebuilt from the host when speculation resumes)
            self.speculative_rollbacks += 1
            self._odo_state = pl.restore(self.map_state, p["ckpt"])
            if commit_n > 0:
                self.speculative_prefix_commits += 1
                _g, scans, ns, ks, per_level = p["upload"]
                dyns, fss = per_level[lvl]
                fss = [f.copy() for f in fss]
                for f in fss[commit_n:]:
                    f[8] = -1.0
                self._odo_state, _rows, syncs, _, _ = self._multi_step(
                    self.map_state, self._odo_state, scans, ns, ks, betas,
                    dyns, fss)
                self.host_syncs += syncs
            for prep in group[commit_n:]:
                yield self.register_frame_prepared(prep)
            if self.next_robust_level in spec_levels:
                self._odo_state = self._odo_state_from_host()
            return "rolledback"

        def drain(group):
            """Per-frame escalation for a whole group; re-enters speculation
            when the level allows it."""
            for prep in group:
                yield self.register_frame_prepared(prep)
            if self.next_robust_level in spec_levels:
                self._odo_state = self._odo_state_from_host()

        self._odo_state = self._odo_state_from_host()
        pending = None
        for upload in map(stack_upload, groups()):
            if self.next_robust_level not in spec_levels:
                # deeply escalated (a frame failed): drain per-frame until
                # the level returns to a speculation level; nothing is in
                # flight here
                assert pending is None
                yield from drain(upload[0])
                continue
            cur = dispatch(upload)
            if pending is not None:
                status = yield from resolve(pending)
                if status in ("rebase", "levelchange", "levelchange_rebase"):
                    # pending committed, but cur ran at the old level or in
                    # the old frame: back to cur's checkpoint (the
                    # post-pending state), rebase if due, redo
                    self._odo_state = pl.restore(self.map_state, cur["ckpt"])
                    if status != "levelchange":
                        self._rebase_stream_head()
                    cur = dispatch(cur["upload"])
                elif status == "rolledback":
                    if self.next_robust_level in spec_levels:
                        # state restored and replayed: cur again, at the
                        # (possibly new) level
                        cur = dispatch(cur["upload"])
                    else:
                        yield from drain(cur["group"])
                        cur = None
            pending = cur
        if pending is not None:
            status = yield from resolve(pending)
            if status in ("rebase", "levelchange_rebase"):
                # nothing in flight: rebase the committed state directly
                self._rebase_stream_head()
        for prep in tail:
            yield self.register_frame_prepared(prep)

    # ---------------------------------------------------------------- helpers —
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
