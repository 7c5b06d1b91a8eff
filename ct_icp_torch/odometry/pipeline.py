"""The per-frame device pipeline around the solver (torch, eager).

Counterpart of ``ct_icp_tpu/odometry/pipeline.py`` on the streamed,
host-deduped path: the u16 scan wire format, the frame core (keypoint
prefix, pre-gather residual-cap decimation, registration, world transform,
assessment, insertion decision, prune + insert) and the streaming body whose
motion initialization, prior and insertion tracker live in the device
vector ``odo_state``.

The reference pads every stage to a capacity ladder so XLA compiles a few
shapes; ladders are exact and only exist for speed, so here every stage is
sliced to its live count instead. The map is updated in place.
"""

import numpy as np
import torch

from ct_icp_torch.core import se3 as s3
from ct_icp_torch.icp import residuals as res
from ct_icp_torch.icp import solver as slv
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.ops.voxel import div_exact

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
    f32 [R])."""
    xyz = packed[:, 0:3].to(torch.float32) / SCAN_QUANT   # exact: 2^-7
    alphas = div_exact((packed[:, 3].to(torch.int32) & 0xFFFF).to(
        torch.float32), 65535.0)
    return xyz, alphas


def scan_rung(cap: int, n: int) -> int:
    """Smallest upload rung (pow-2 ladder from SCAN_RUNG_MIN) holding n."""
    r = SCAN_RUNG_MIN
    while r < cap:
        if n <= r:
            return r
        r *= 2
    return cap


def transform_points(raw, alphas, qb, tb, qe, te):
    """world = interp(alpha) * raw for every point."""
    return res.interp_world_points(qb, tb, qe, te, raw, alphas)


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


def make_frame_core(map_options, statics, sub_capacity: int):
    """One odometry frame on the streamed path: keypoint prefix ->
    decimation -> CT registration -> world transform -> assessment ->
    insertion decision -> prune + insert (in place on ``map_state``).

    frame_scalars ``fs`` (f32[17]) follow the reference layout
    (pipeline.py:195-225): 0 voxel_size, 1 sample_voxel_size,
    2 max_distance, 5 insertion_ego_rotation_threshold,
    7 insertion_threshold_frames_skipped, 8 distance_error_threshold,
    9 orientation_error_threshold, 10 do_prune, 11-14 robust assessment
    terms, 15 insert election rounds, 16 keypoint-prefix count.

    Returns (packed f32[24] in the reference layout, add bool tensor,
    host_syncs)."""
    resolutions = tuple(r.resolution for r in map_options.resolutions)
    min_dists = tuple(r.min_distance_between_points
                      for r in map_options.resolutions)
    kp_capacity = statics.num_keypoints
    register = slv.build_register_fn(statics)

    def core(map_state, raw, alphas, n_points: int, qb0, tb0, qe0, te0,
             prior, dyn_packed, fs, do_register: bool, force_insert,
             skipped):
        dev = raw.device
        sub_cnt = min(n_points, sub_capacity)
        sub_raw, sub_alphas = raw[:sub_cnt], alphas[:sub_cnt]
        if fs[16] <= 0:
            raise NotImplementedError(
                "the device keypoint grid election is not ported: "
                "prepare frames with the host keypoint prefix")
        kp_cnt = min(int(fs[16]), kp_capacity)
        kp_raw, kp_alphas = sub_raw[:kp_cnt], sub_alphas[:kp_cnt]
        keep = decimation_indices(kp_cnt, int(dyn_packed[_MNR_INDEX]))
        if keep is not None:
            keep_t = torch.as_tensor(keep, device=dev)
            kp_raw, kp_alphas = kp_raw[keep_t], kp_alphas[keep_t]
        kp_valid = torch.ones(kp_raw.shape[0], dtype=torch.bool, device=dev)

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
        add = torch.where(force_insert < 0, torch.zeros_like(assess_ok),
                          torch.where(force_insert > 0,
                                      torch.ones_like(assess_ok),
                                      heuristic_add)) & assess_ok

        inserted = torch.zeros(1, dtype=torch.int32, device=dev)
        valid = add.reshape(1).expand(sub_cnt).contiguous()
        for i, level in enumerate(map_state):
            if fs[10] > 0:      # cadence prune, gated by the assessment
                vm.prune_level(level, te, fs[2], gate=assess_ok)
            inserted = inserted + vm.insert_points(
                level, world, valid, resolutions[i], min_dists[i],
                max_rounds=int(fs[15]))

        f32 = dict(dtype=torch.float32, device=dev)
        host = torch.tensor([result.num_iters, float(result.converged),
                             float(result.valid_problem), sub_cnt,
                             kp_raw.shape[0]], **f32)
        packed = torch.cat([
            qb, tb, qe, te, result.num_residuals.to(**f32).reshape(1),
            host, inserted.to(torch.float32),
            add.to(**f32).reshape(1), assess_ok.to(**f32).reshape(1),
            rot_within.to(**f32).reshape(1)])
        return packed, add, result.host_syncs

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


def make_stream_body(map_options, statics, sub_capacity: int,
                     const_velocity: bool, continuous: bool,
                     always_insert: bool, do_no_insert: bool):
    """Per-frame streaming body:
      (map_state, odo_state, scan_packed, n, k, prior_betas, dyn, fs)
        -> (odo_state, packed [24], host_syncs)
    ``k`` is the frame's registration index — the host's copy of
    odo_state[28] (the reference reads it on the device)."""
    core = make_frame_core(map_options, statics, sub_capacity)

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
        else:
            force_insert = (total_ins < 0.5).to(torch.float32)

        packed, add, syncs = core(map_state, raw, alphas, n_points, qb0, tb0,
                                  qe0, te0, prior, dyn_packed, fs, k > 0,
                                  force_insert, skipped)

        # ---- tracker + state update
        addf = add.to(torch.float32)
        new_skipped = torch.where(add, torch.zeros_like(skipped), skipped + 1.0)
        new_state = torch.cat([
            packed[0:14],                  # optimized poses -> prev
            pb_q, pb_t, pe_q, pe_t,        # old prev -> prev2
            torch.stack([s[28] + 1.0, new_skipped, total_ins + addf,
                         torch.zeros_like(addf)]),
        ])
        return new_state, packed, syncs

    return stream_body
