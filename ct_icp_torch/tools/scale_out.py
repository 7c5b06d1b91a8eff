"""The scale-out path's rank bodies and measures (``chip_smoke.py``'s
scale-out phases).

The rank bodies run in processes that ``parallel/comm.py::spawn`` starts,
several of which may share one card (gloo): each takes the card's first
device and returns numpy results and its own kernels' launch counts.

    python3 chip_smoke.py      # runs them (its scale-out phases)
"""

import time

import numpy as np
import torch

from ct_icp_torch import convert
from ct_icp_torch.config.options import default_driving_profile
from ct_icp_torch.kernels import candidate_gather as k1
from ct_icp_torch.kernels import ct_ba_block as k8
from ct_icp_torch.kernels import grid_sample as k4
from ct_icp_torch.kernels import level_normals as k10
from ct_icp_torch.kernels import lm_step as k5
from ct_icp_torch.kernels import map_insert as k3
from ct_icp_torch.kernels import owner_pack as k11
from ct_icp_torch.kernels import plane_moments as k2
from ct_icp_torch.kernels import prune_levels as k15
from ct_icp_torch.kernels import scan_transform as k14
from ct_icp_torch.parallel import ct_ba
from ct_icp_torch.parallel.distributed_odometry import DistributedOdometry

# the kernels of the scale-out paths, by the names chip_smoke.py gives them
PATH_KERNELS = {"candidate_gather": k1, "plane_moments": k2,
                "map_insert": k3, "grid_sample": k4, "lm_step": k5,
                "level_normals": k10, "owner_pack": k11,
                "ct_ba_block": k8, "scan_transform": k14,
                "prune_levels": k15}


def reset_launches():
    for m in PATH_KERNELS.values():
        m.launches = 0


def read_launches():
    return {name: m.launches for name, m in PATH_KERNELS.items()}


def ape(trajectory, frames):
    """Per-frame end-pose translation errors against the ground truth, the
    estimate starting at frame 0's (``datasets/corridor.py::seq_ape`` for a
    trajectory list)."""
    first_gt = frames[0]["begin_pose"]
    return [float(np.linalg.norm(est.end_pose.tr
                                 - (first_gt.inverse() * fr["end_pose"]).tr))
            for est, fr in zip(trajectory, frames)]


def live_points(levels):
    """Each level's stored points, [N, 3] sorted rows (numpy), of a shard
    given as ``convert.map_state_to_numpy`` dicts."""
    out = []
    for lvl in levels:
        c = len(lvl["keys"])
        p = lvl["points"].reshape(c, 3, -1).transpose(0, 2, 1)
        live = (lvl["keys"] > 1) & (lvl["count"] > 0)
        cap = (np.arange(p.shape[1])[None, :]
               < np.where(live, lvl["count"], 0)[:, None])
        pts = p[cap]
        out.append(pts[np.lexsort(pts.T)])
    return out


def merge_points(per_shard):
    """Each shard's :func:`live_points` -> their union, level by level,
    sorted."""
    out = []
    for i in range(len(per_shard[0])):
        allp = np.concatenate([p[i] for p in per_shard])
        out.append(allp[np.lexsort(allp.T)])
    return out


def union_points(shards):
    """The union of the shards' stored points (``map_state_to_numpy``
    dicts), level by level, sorted (the reference test's
    ``_all_shard_points``)."""
    return merge_points([live_points(s) for s in shards])


def rank_odometry(group, frames, modes):
    """``DistributedOdometry(default_driving_profile())`` over ``frames``
    (dicts with ``xyz`` and ``timestamps``) on the card, once a mode: the
    end poses [F, 7] (tr, quat), the dropped points, this rank's shard
    after the first frame and after the last, the seconds the frames took
    (the first frame's copy of the shard left out), the kernels' launches
    and K5's LM steps."""
    torch.cuda.set_device(0)
    out = {}
    for mode in modes:
        odo = DistributedOdometry(default_driving_profile(), group,
                                  device="cuda", map_update=mode)
        torch.cuda.synchronize()
        reset_launches()
        k5.reset_steps()
        t0 = time.time()
        for i, fr in enumerate(frames):
            odo.register_frame(fr["xyz"], fr["timestamps"])
            if i == 0:
                torch.cuda.synchronize()
                t_copy = time.time()
                first = live_points(convert.map_state_to_numpy(
                    odo.map_state.levels))
                t0 += time.time() - t_copy
        torch.cuda.synchronize()
        seconds = time.time() - t0
        out[mode] = {
            "end": np.array([np.concatenate([f.end_pose.tr, f.end_pose.quat])
                             for f in odo.trajectory]),
            "dropped": odo.dropped_points, "first_map": first,
            "levels": convert.map_state_to_numpy(odo.map_state.levels),
            "seconds": seconds, "launches": read_launches(),
            "lm_steps": int(k5.steps_counter("cuda")[0])}
        del odo
        torch.cuda.empty_cache()
    return out


def rank_ct_ba(group, state, problem, configs):
    """This rank's slice of a CT-BA window (numpy, the whole window) on the
    card, stepped by each config (``make_ct_ba_step`` keywords): the
    slice's new state, the window's cost and the K8 launches."""
    torch.cuda.set_device(0)
    st, pr = convert.ct_ba_from_numpy(state, problem, device="cuda")
    st, pr = ct_ba.shard_problem(st, pr, group)
    out = []
    for cfg in configs:
        reset_launches()
        new, cost = ct_ba.make_ct_ba_step(group=group, **cfg)(st, pr)
        out.append({"state": convert.ct_ba_to_numpy(new),
                    "cost": float(cost), "launches": read_launches()})
    return out


def rank_scale_out(group, frames, modes, state, problem, configs):
    """:func:`rank_odometry` then :func:`rank_ct_ba`, in one process."""
    return {"odometry": rank_odometry(group, frames, modes),
            "ct_ba": rank_ct_ba(group, state, problem, configs)}
