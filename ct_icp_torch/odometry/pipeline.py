"""The per-frame device pipeline around the solver (torch, eager).

Counterpart of ``ct_icp_tpu/odometry/pipeline.py``: the u16 scan wire
format, the staged path's stages (``preprocess``: the raw scan's
sub-sample, K4; ``sample_keypoints``: the keypoint grid election, K4), the
frame core (the device sub-sample of a raw scan the host did
not dedup, the keypoint prefix or the device keypoint grid election,
pre-gather residual-cap decimation,
registration, world transform, assessment, insertion decision — heuristic,
forced or robust-gated — prune + insert), the per-frame step of the
``register_frame`` path, the deferred map update, the streaming body whose
motion initialization, prior and insertion tracker live in the device
vector ``odo_state``, the multi-frame step with its rollback checkpoint, and
the floating-origin rebase of the map (and of the streaming state).

The reference pads every stage to a capacity ladder so XLA compiles a few
shapes; ladders are exact and only exist for speed, so here every stage is
sliced to its live count instead (the keypoint election, whose count stays
on the device, keeps its capacity and a validity mask, and so does the
device sub-sample). The map is updated in place, so a checkpoint is a
device copy of it (``snapshot``). Where the solver reads the per-voxel
normals (the distance strategy's normal filter), every insert keeps them,
oriented toward the frame's begin translation (``with_normals``): each
level's dirty list is read back to size it, one host sync a level.
"""

from typing import NamedTuple

import numpy as np
import torch

from ct_icp_torch.core import se3 as s3
from ct_icp_torch.icp import solver as slv
from ct_icp_torch.kernels import scan_transform as k14
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.ops import sampling as smp
from ct_icp_torch.ops import voxel as vx

# index of max_num_residuals in the packed solver-dynamics vector (the
# pre-gather keypoint decimation reads it)
_MNR_INDEX = slv.SolverDynamics._fields.index("max_num_residuals")

# --- quantized scan wire format: points as int16 at 1/128 m, alphas as u16
SCAN_QUANT = 128.0  # 1/128 m per LSB, +-255.99 m range
SCAN_RUNG_MIN = 32768


def pack_scan_u16(xyz, alphas, n: int, rung: int):
    """Host-side wire packing: [n,3] points + [n] alphas -> u16[rung, 4]."""
    out = np.zeros((rung, 4), np.uint16)
    q = np.clip(np.rint(np.asarray(xyz[:n]) * SCAN_QUANT),
                -32767, 32767).astype(np.int16)
    out[:n, :3] = q.view(np.uint16)
    out[:n, 3] = np.clip(np.rint(np.asarray(alphas[:n]) * 65535.0),
                         0, 65535).astype(np.uint16)
    return out


def unpack_scan(packed):
    """Device-side unpack of pack_scan_u16, given as its int16 view
    (torch has no general uint16 arithmetic) -> (xyz f32 [R,3], alphas
    f32 [R]). Kernel K14 on the card (one launch)."""
    return k14.unpack(packed)


def scan_rung(cap: int, n: int) -> int:
    """Smallest upload rung (pow-2 ladder from SCAN_RUNG_MIN) holding n."""
    r = SCAN_RUNG_MIN
    while r < cap:
        if n <= r:
            return r
        r *= 2
    return cap


def transform_points(raw, alphas, qb, tb, qe, te):
    """world = interp(alpha) * raw for every point (kernel K14 on the card,
    one launch)."""
    return k14.transform(raw, alphas, qb, tb, qe, te)


def distort_raw(raw, alphas, qb, tb, qe, te):
    """The CONSTANT_VELOCITY motion compensation: raw points bent into the
    end pose's frame, raw' = end^-1 * interp(alpha) * raw (reference
    pipeline.py:56, odometry.cpp:162-170; kernel K14 on the card, one
    launch)."""
    return k14.transform(raw, alphas, qb, tb, qe, te, distort=True)


def preprocess(raw, alphas, valid, voxel_size: float, capacity: int):
    """Voxel-grid subsample the raw scan (K4, a 2^22 table) -> the
    sub-frame (raw f32[capacity, 3], alphas f32[capacity], valid
    bool[capacity], count 0-dim int32); rows past the count copy row 0 and
    are masked. The caller may pass the scan's upload rung instead of the
    whole raw buffer: the rows past the scan are invalid, so no voxel and
    no index changes."""
    idx, ok, cnt = smp.voxel_subsample_indices(raw, valid, voxel_size,
                                               capacity)
    idx = idx.to(torch.int64)
    return raw[idx], alphas[idx], ok, cnt


def sample_keypoints(sub_raw, sub_alphas, sub_valid, sample_voxel_size: float,
                     capacity: int):
    """Grid-sample keypoints from the sub-frame (K4 by raw-point voxels)
    -> (raw, alphas, valid, count) at ``capacity`` rows."""
    idx, ok, cnt = smp.voxel_subsample_indices(sub_raw, sub_valid,
                                               sample_voxel_size, capacity)
    idx = idx.to(torch.int64)
    return sub_raw[idx], sub_alphas[idx], ok, cnt


def decimation_indices(kp_cnt: int, max_num_residuals: int):
    """The pre-gather residual-cap decimation: indices of the keypoints a
    uniform stride keeps at 1.5x the residual cap (None = keep all)."""
    if max_num_residuals <= 0:
        return None
    target = max((3 * max_num_residuals) // 2, 256)
    if kp_cnt <= target:
        return None
    live = max(kp_cnt, 1)
    t_eff = min(target, live)
    pos = np.arange(kp_cnt, dtype=np.int64)
    sel = (pos * t_eff) // live != ((pos - 1) * t_eff) // live
    return np.nonzero(sel)[0]


def device_decimation(kp_valid, kp_cnt, max_num_residuals: int):
    """``decimation_indices`` with the keypoint count on the device (the
    keypoint election's): returns (indices, count, valid) of the kept
    keypoints, compacted, at the input's capacity."""
    k = kp_valid.shape[0]
    target = max((3 * max_num_residuals) // 2, 256)
    live = torch.clamp_min(kp_cnt.to(torch.int64), 1)
    t_eff = torch.clamp_max(live, target)
    pos = torch.arange(k, dtype=torch.int64, device=kp_valid.device)
    sel = (torch.div(pos * t_eff, live, rounding_mode="floor")
           != torch.div((pos - 1) * t_eff, live, rounding_mode="floor"))
    keep = kp_valid & (sel | (kp_cnt <= target))
    idx, cnt, valid = vx.compact_mask(keep, k)
    return idx.to(torch.int64), cnt, valid


class FrameResult(NamedTuple):
    packed: torch.Tensor      # f32[24], the reference layout
    add: torch.Tensor         # bool: the frame's points went into the map
    world: torch.Tensor       # f32[S, 3] corrected sub-frame points
    world_valid: torch.Tensor  # bool[S]: the live rows of ``world``
    host_syncs: int           # device->host reads the solver and inserts made
    # the solver's keypoints (raw f32[K, 3], alphas f32[K], valid bool[K]):
    # the prefix (K its length) or the device election (K the capacity)
    keypoints: tuple


def insert_world(level, world, valid, resolution: float, min_dist: float,
                 max_rounds: int, with_normals: bool, begin_tr,
                 max_dirty: int):
    """One level's insert of a frame's world points (K3); ``with_normals``:
    the dirty voxels' normals refit toward ``begin_tr`` (K10), reading the
    dirty list's length back (one sync). Returns (inserted int32[1], host
    syncs)."""
    if not with_normals:
        return vm.insert_points(level, world, valid, resolution, min_dist,
                                max_rounds), 0
    return vm.insert_points(level, world, valid, resolution, min_dist,
                            max_rounds, begin_tr=begin_tr,
                            max_dirty=max_dirty), 1


def make_frame_core(map_options, statics, sub_capacity: int,
                    host_prededuped: bool = True,
                    max_dirty: int = 1 << 15,
                    distort_constant_velocity: bool = False):
    """One odometry frame: the device sub-sample of the raw scan (when the
    host did not dedup it) -> with ``distort_constant_velocity``, the
    sub-frame bent by the initial poses (:func:`distort_raw`; reference
    pipeline.py:275-276) -> keypoint prefix (or the device grid election)
    -> decimation -> CT registration -> world transform -> assessment ->
    insertion decision -> prune + insert (in place on ``map_state``; with
    the voxel normals where the solver reads them).

    frame_scalars ``fs`` (f32[17]) follow the reference layout
    (pipeline.py:195-225): 0 voxel_size, 1 sample_voxel_size,
    2 max_distance, 3 do_register, 4 force_insert, 5
    insertion_ego_rotation_threshold, 6 skipped_frames, 7
    insertion_threshold_frames_skipped, 8 distance_error_threshold,
    9 orientation_error_threshold, 10 do_prune, 11-14 robust assessment
    terms, 15 insert election rounds, 16 keypoint-prefix count (0: run the
    keypoint grid election on the device, kernel K4). Entries 3, 4 and 6
    arrive as the arguments ``do_register``, ``force_insert`` (-1 none,
    0 heuristic, 1 force, 2 robust-gated: insert only when the rotation
    stays within the robust thresholds) and ``skipped``.

    Returns a FrameResult."""
    resolutions = tuple(r.resolution for r in map_options.resolutions)
    min_dists = tuple(r.min_distance_between_points
                      for r in map_options.resolutions)
    kp_capacity = statics.num_keypoints
    register = slv.build_register_fn(statics)
    with_normals = statics.use_normal_filter

    def core(map_state, raw, alphas, n_points: int, qb0, tb0, qe0, te0,
             prior, dyn_packed, fs, do_register: bool, force_insert,
             skipped):
        dev = raw.device
        if host_prededuped:
            sub_cnt = min(n_points, sub_capacity)
            sub_raw, sub_alphas = raw[:sub_cnt], alphas[:sub_cnt]
            sub_valid = torch.ones(sub_cnt, dtype=torch.bool, device=dev)
            sub_count = float(sub_cnt)
        else:
            # the device sub-sample (reference pipeline.py:264-270): K4
            # over the uploaded scan's rung at fs[0]; its count stays on
            # the device, so the sub-frame keeps the capacity and a mask
            scan_valid = torch.arange(raw.shape[0], device=dev) < n_points
            idx, sub_valid, sub_cnt_t = smp.voxel_subsample_indices(
                raw, scan_valid, float(fs[0]), sub_capacity)
            idx = idx.to(torch.int64)
            sub_raw, sub_alphas = raw[idx], alphas[idx]
            sub_count = sub_cnt_t.to(torch.float32).reshape(1)
        if distort_constant_velocity:
            sub_raw = distort_raw(sub_raw, sub_alphas, qb0, tb0, qe0, te0)
        mnr = int(dyn_packed[_MNR_INDEX])
        if fs[16] > 0:
            # KEYPOINT PREFIX: prepare_frame put the fs[1]-grid winners
            # first, so the election's result is a slice of known length
            kp_cnt = min(int(fs[16]), kp_capacity)
            kp_raw, kp_alphas = sub_raw[:kp_cnt], sub_alphas[:kp_cnt]
            keep = decimation_indices(kp_cnt, mnr)
            if keep is not None:
                keep_t = torch.as_tensor(keep, device=dev)
                kp_raw, kp_alphas = kp_raw[keep_t], kp_alphas[keep_t]
            kp_valid = torch.ones(kp_raw.shape[0], dtype=torch.bool,
                                  device=dev)
            kp_count = torch.tensor(float(kp_raw.shape[0]), device=dev)
        else:
            # the keypoint grid election at fs[1] (robust escalation shrinks
            # the sample voxel below the prefix's): its count stays on the
            # device, so the keypoints keep the capacity and a mask
            idx, kp_valid, kp_cnt_t = smp.voxel_subsample_indices(
                sub_raw, sub_valid, float(fs[1]), kp_capacity)
            idx = idx.to(torch.int64)
            kp_raw, kp_alphas = sub_raw[idx], sub_alphas[idx]
            if mnr > 0:
                didx, kp_cnt_t, kp_valid = device_decimation(
                    kp_valid, kp_cnt_t, mnr)
                kp_raw, kp_alphas = kp_raw[didx], kp_alphas[didx]
            kp_count = kp_cnt_t.to(torch.float32)

        dyn = slv.unpack_dynamics(dyn_packed)
        if not do_register:     # frame 0: poses pass through
            dyn = dyn._replace(num_iters_icp=0)
        result = register(map_state[statics.level_index], kp_raw, kp_alphas,
                          kp_valid, qb0, tb0, qe0, te0, prior, dyn)
        qb, tb = result.quat_begin, result.tr_begin
        qe, te = result.quat_end, result.tr_end
        world = transform_points(sub_raw, sub_alphas, qb, tb, qe, te)

        # ---- assessment (reference AssessRegistration, odometry.cpp:604-684)
        rel_dist = torch.linalg.norm(te - tb)
        ego_or = s3.angular_distance_deg(qb, qe)
        rel_or = s3.angular_distance_deg(prior[0:4], qe)
        rot_within = (rel_or <= fs[11]) & (ego_or <= fs[12])
        robust_ok = rel_dist <= fs[13]
        if fs[14] > 0:
            robust_ok = robust_ok & rot_within
        if do_register:
            assess_ok = ((rel_dist <= fs[8]) & (rel_or <= fs[9])
                         & (ego_or <= fs[9]) & robust_ok
                         & bool(result.valid_problem))
        else:
            assess_ok = torch.ones((), dtype=torch.bool, device=dev)

        # ---- insertion decision (reference UpdateMap, odometry.cpp:918-933)
        heuristic_add = torch.where(ego_or > fs[5], skipped > fs[7],
                                    torch.ones_like(assess_ok))
        add = torch.where(
            force_insert < 0, torch.zeros_like(assess_ok),
            torch.where(force_insert > 1.5, rot_within,
                        torch.where(force_insert > 0,
                                    torch.ones_like(assess_ok),
                                    heuristic_add))) & assess_ok

        inserted = torch.zeros(1, dtype=torch.int32, device=dev)
        valid = sub_valid & add
        syncs = result.host_syncs
        if fs[10] > 0:      # cadence prune of every level (K15, one
            # launch), gated by the assessment
            vm.prune_levels(map_state, te, fs[2], gate=assess_ok)
        for i, level in enumerate(map_state):
            n_ins, s = insert_world(level, world, valid, resolutions[i],
                                    min_dists[i], int(fs[15]), with_normals,
                                    tb, max_dirty)
            inserted = inserted + n_ins
            syncs += s

        f32 = dict(dtype=torch.float32, device=dev)
        host = [result.num_iters, float(result.converged),
                float(result.valid_problem)]
        # the sub-frame's count: a host value, or the device sub-sample's
        # (kept on the card); one upload of the host values either way
        counts = ([torch.tensor(host + [sub_count], **f32)]
                  if isinstance(sub_count, float)
                  else [torch.tensor(host, **f32), sub_count])
        packed = torch.cat([
            qb, tb, qe, te, result.num_residuals.to(**f32).reshape(1),
            *counts, kp_count.reshape(1), inserted.to(torch.float32),
            add.to(**f32).reshape(1), assess_ok.to(**f32).reshape(1),
            rot_within.to(**f32).reshape(1)])
        return FrameResult(packed, add, world, sub_valid, syncs,
                           (kp_raw, kp_alphas, kp_valid))

    return core


# odo_state layout for the streaming step (f32[32]):
#   0:4  prev_begin_quat    4:7  prev_begin_tr
#   7:11 prev_end_quat     11:14 prev_end_tr
#  14:18 prev2_begin_quat  18:21 prev2_begin_tr
#  21:25 prev2_end_quat    25:28 prev2_end_tr
#  28 registered_fid  29 skipped_frames  30 total_insertions  31 unused
ODO_STATE_SIZE = 32


def init_odo_state():
    s = np.zeros(ODO_STATE_SIZE, np.float32)
    s[0] = s[7] = s[14] = s[21] = 1.0  # identity quaternions
    return s


def make_frame_step(map_options, statics, sub_capacity: int,
                    host_prededuped: bool = True, max_dirty: int = 1 << 15,
                    distort_constant_velocity: bool = False):
    """One frame of the per-frame (``register_frame``) path, the pose
    initialization and the prior given by the host (reference
    make_frame_step_fn, pipeline.py:434-458):
      (map_state, scan_packed, n, pose_init [14], prior [14], dyn, fs)
        -> FrameResult
    with do_register, force_insert and skipped in fs[3], fs[4], fs[6]."""
    core = make_frame_core(map_options, statics, sub_capacity,
                           host_prededuped, max_dirty,
                           distort_constant_velocity)

    def frame_step(map_state, scan_packed, n_points: int, pose_init, prior,
                   dyn_packed, fs):
        raw, alphas = unpack_scan(scan_packed)
        dev = raw.device
        return core(map_state, raw, alphas, n_points, pose_init[0:4],
                    pose_init[4:7], pose_init[7:11], pose_init[11:14], prior,
                    dyn_packed, fs, bool(fs[3] > 0),
                    torch.tensor(float(fs[4]), device=dev),
                    torch.tensor(float(fs[6]), device=dev))

    return frame_step


def update_map(map_state, map_options, world, valid, location,
               max_distance: float, do_insert: bool, prune: bool,
               with_normals: bool = False, begin_tr=None,
               max_dirty: int = 1 << 15):
    """The deferred map update (reference _update_map_impl,
    pipeline.py:71-84): an optional prune around ``location``, then the
    insert of ``world`` where ``valid`` and ``do_insert``, in place on every
    level (``with_normals``: the dirty voxels' normals refit toward
    ``begin_tr``). Returns (the points inserted int32[1], host syncs)."""
    inserted = torch.zeros(1, dtype=torch.int32, device=world.device)
    valid = valid & do_insert
    syncs = 0
    if prune:
        vm.prune_levels(map_state, location, max_distance)
    for level, r in zip(map_state, map_options.resolutions):
        n_ins, s = insert_world(level, world, valid, r.resolution,
                                r.min_distance_between_points, 4,
                                with_normals, begin_tr, max_dirty)
        inserted = inserted + n_ins
        syncs += s
    return inserted, syncs


def upload(arrays, device):
    """numpy arrays -> tensors of the same dtypes and shapes on ``device``.
    On the card one pinned staging buffer and one copy that does not block
    the host (a pageable copy waits for everything queued on the stream);
    on the CPU, tensors over the arrays."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if torch.device(device).type != "cuda":
        return [torch.from_numpy(a) for a in arrays]
    offsets, at = [], 0
    for a in arrays:
        offsets.append(at)
        at += (a.nbytes + 15) // 16 * 16
    host = torch.empty(max(at, 16), dtype=torch.uint8, pin_memory=True)
    flat = host.numpy()
    for a, o in zip(arrays, offsets):
        flat[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True)
    return [buf[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, offsets)]


def snapshot(map_state, odo_state):
    """A device copy of the map and the odometry state: the rollback point
    of a speculative batch. The reference's functional map makes this an
    output of the batch's program (make_multi_step_fn, with_checkpoint);
    here the batch updates the map in place, so the copy is taken before
    it runs (about 265 MB at the robust profile's 2^19 x 40-point level)."""
    return (tuple(vm.MapLevel(*(t.clone() for t in level))
                  for level in map_state), odo_state.clone())


def restore(map_state, ckpt):
    """Roll ``map_state`` back to the checkpoint, in place; returns the
    checkpoint's odometry state (a copy: the checkpoint stays usable)."""
    levels, odo_state = ckpt
    for level, saved in zip(map_state, levels):
        for t, s in zip(level, saved):
            t.copy_(s)
    return odo_state.clone()


def make_stream_body(map_options, statics, sub_capacity: int,
                     const_velocity: bool, continuous: bool,
                     always_insert: bool, do_no_insert: bool,
                     robust_gated: bool = False,
                     host_prededuped: bool = True,
                     max_dirty: int = 1 << 15,
                     distort_constant_velocity: bool = False):
    """Per-frame streaming body:
      (map_state, odo_state, scan_packed, n, k, prior_betas, dyn, fs)
        -> (odo_state, packed [24], host_syncs, (world, world_valid))
    ``k`` is the frame's registration index — the host's copy of
    odo_state[28] (the reference reads it on the device).
    ``robust_gated``: insertion mode 2 (insert only when the on-device
    robust assessment passes) after the first inserted frame — the
    speculative robust streamer's mode."""
    core = make_frame_core(map_options, statics, sub_capacity,
                           host_prededuped, max_dirty,
                           distort_constant_velocity)

    def stream_body(map_state, odo_state, scan_packed, n_points: int, k: int,
                    prior_betas, dyn_packed, fs):
        raw, alphas = unpack_scan(scan_packed)
        s = odo_state
        pb_q, pb_t = s[0:4], s[4:7]
        pe_q, pe_t = s[7:11], s[11:14]
        p2b_q, p2b_t = s[14:18], s[18:21]
        p2e_q, p2e_t = s[21:25], s[25:28]
        skipped, total_ins = s[29], s[30]

        # ---- motion initialization (reference InitializeMotion,
        # odometry.cpp:276-330)
        ident_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=s.device)
        ident_t = torch.zeros(3, device=s.device)
        if k <= 1:
            qb0, tb0, qe0, te0 = ident_q, ident_t, ident_q, ident_t
        elif const_velocity:
            # end-pose extrapolation: prev_end * (prev2_end^-1 * prev_end)
            rel_q, rel_t = s3.se3_compose(*s3.se3_inverse(p2e_q, p2e_t),
                                          pe_q, pe_t)
            qe0, te0 = s3.se3_compose(pe_q, pe_t, rel_q, rel_t)
            if k == 2 or not continuous:
                qb0, tb0 = pe_q, pe_t
            else:       # begin extrapolated from the begin poses
                rb_q, rb_t = s3.se3_compose(*s3.se3_inverse(p2b_q, p2b_t),
                                            pb_q, pb_t)
                qb0, tb0 = s3.se3_compose(pb_q, pb_t, rb_q, rb_t)
        else:
            qb0, tb0, qe0, te0 = pe_q, pe_t, pe_q, pe_t
        qb0 = s3.quat_normalize(qb0)
        qe0 = s3.quat_normalize(qe0)

        # ---- motion-model prior (registration.make_prior layout)
        prior = torch.cat([pe_q, pe_t, pe_t - pb_t, prior_betas])
        if do_no_insert:
            force_insert = torch.tensor(-1.0, device=s.device)
        elif always_insert:
            force_insert = torch.tensor(1.0, device=s.device)
        elif robust_gated:
            force_insert = torch.where(total_ins < 0.5, 1.0, 2.0)
        else:
            force_insert = (total_ins < 0.5).to(torch.float32)

        out = core(map_state, raw, alphas, n_points, qb0, tb0, qe0, te0,
                   prior, dyn_packed, fs, k > 0, force_insert, skipped)
        packed, add = out.packed, out.add

        # ---- tracker + state update
        addf = add.to(torch.float32)
        new_skipped = torch.where(add, torch.zeros_like(skipped), skipped + 1.0)
        new_state = torch.cat([
            packed[0:14],                  # optimized poses -> prev
            pb_q, pb_t, pe_q, pe_t,        # old prev -> prev2
            torch.stack([s[28] + 1.0, new_skipped, total_ins + addf,
                         torch.zeros_like(addf)]),
        ])
        return new_state, packed, out.host_syncs, (out.world, out.world_valid)

    return stream_body


def make_multi_step(body):
    """A batch of frames through the streaming ``body``, one after another
    (reference make_multi_step_fn, pipeline.py:599-667):
      (map_state, odo_state, scans [B, R, 4], ns, ks, betas, dyns, fss,
       with_checkpoint) -> (odo_state, packed [B, 24], host_syncs, ckpt,
       worlds)
    ``ckpt`` (with_checkpoint) is the snapshot of the map and the odometry
    state before the batch — the speculative robust streamer's rollback
    point — else None; ``worlds`` the frames' (world, world_valid) device
    tensors."""

    def multi_step(map_state, odo_state, scans, ns, ks, betas, dyns, fss,
                   with_checkpoint: bool = False):
        ckpt = snapshot(map_state, odo_state) if with_checkpoint else None
        rows, syncs, worlds = [], 0, []
        for b in range(len(ns)):
            odo_state, row, s, world = body(map_state, odo_state, scans[b],
                                            ns[b], ks[b], betas, dyns[b],
                                            fss[b])
            rows.append(row)
            worlds.append(world)
            syncs += s
        return odo_state, torch.stack(rows), syncs, ckpt, worlds

    return multi_step


# the pose translations carried in odo_state (prev/prev2 begin/end)
_ODO_TRANSLATIONS = (4, 11, 18, 25)


def make_rebase_fn(map_options):
    """The map rebase (reference make_rebase_fn, pipeline.py:679-689):
      (map_state, shift f32[3] on the device) -> the rebuilt map_state,
    every level shifted and rehashed (``voxel_map.rebuild_level``)."""
    resolutions = tuple(r.resolution for r in map_options.resolutions)

    def rebase(map_state, shift):
        return tuple(vm.rebuild_level(level, shift, res)
                     for level, res in zip(map_state, resolutions))

    return rebase


def make_stream_rebase_fn(map_options):
    """The rebase of the streaming path (reference make_stream_rebase_fn,
    pipeline.py:692-708): the map, and the pose translations carried in
    ``odo_state`` (bases 4, 11, 18, 25):
      (map_state, odo_state, shift) -> (map_state, odo_state)."""
    rebase = make_rebase_fn(map_options)

    def stream_rebase(map_state, odo_state, shift):
        new_state = odo_state.clone()
        for base in _ODO_TRANSLATIONS:
            new_state[base:base + 3] = odo_state[base:base + 3] - shift
        return rebase(map_state, shift), new_state

    return stream_rebase
