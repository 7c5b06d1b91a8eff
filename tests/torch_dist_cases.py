"""Rank bodies of the port's multi-rank tests (``ct_icp_torch.parallel``).

Each function runs in a process that ``ct_icp_torch.parallel.comm.spawn``
started (gloo over a FileStore, one rank a process, the CPU) and returns
numpy results to the test process. This module imports no JAX and nothing
of ``ct_icp_tpu``: a rank's process must load neither (the test process
runs the JAX reference itself). Not collected by pytest (no ``test_``
prefix).
"""

import numpy as np
import torch

from ct_icp_torch import convert
from ct_icp_torch.parallel import comm
from ct_icp_torch.parallel import ct_ba
from ct_icp_torch.parallel import sharded_map as sm
from ct_icp_torch.parallel.distributed_odometry import DistributedOdometry


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _update(options, mode, max_dirty, group, slack):
    if mode == "partitioned":
        return sm.make_partitioned_update_fn(options, max_dirty, group,
                                             slack=slack)
    return sm.make_sharded_update_fn(options, max_dirty, group)


def sharded_map_cases(group, cases):
    """Each case: a fresh sharded map of ``options``, then its ``updates``
    in order (mode, world, valid, begin_tr, location, max_distance,
    max_dirty, slack), then its ``queries`` (level, nv, queries, radius).
    Returns per case this rank's shard (``map_state_to_numpy``), the
    inserted and dropped totals of each update and each query's combined
    moments."""
    out = {}
    for name, case in cases.items():
        state = sm.make_sharded_map(case["options"], group, "cpu")
        counts = []
        for (mode, world, valid, begin_tr, location, max_distance,
             max_dirty, slack) in case["updates"]:
            upd = _update(case["options"], mode, max_dirty, group, slack)
            res = upd(state, _t(world), _t(valid, torch.bool), _t(begin_tr),
                      _t(location), max_distance)
            state = res[0]
            counts.append([int(x) for x in res[1:]])
        queries = []
        for level, nv, q, radius in case.get("queries", ()):
            fn = sm.make_sharded_ball_query_fn(case["options"], level, nv,
                                               group)
            r = fn(state, _t(q), torch.ones(len(q), dtype=torch.bool),
                   radius)
            queries.append([x.numpy() for x in r])
        out[name] = {"levels": convert.map_state_to_numpy(state.levels),
                     "counts": counts, "queries": queries}
    return out


def odometry_runs(group, options, scans, modes):
    """``DistributedOdometry`` over ``scans`` [(xyz, timestamps)] once a
    mode: each frame's (begin tr, begin quat, end tr, end quat), the map
    size, the dropped points and this rank's shard."""
    out = {}
    for mode in modes:
        odo = DistributedOdometry(options, group, device="cpu",
                                  map_update=mode)
        for xyz, ts in scans:
            odo.register_frame(xyz, ts)
        out[mode] = {
            "poses": _poses(odo),
            "map_size": odo.map_size(),
            "dropped": odo.dropped_points,
            "levels": convert.map_state_to_numpy(odo.map_state.levels)}
    return out


def _poses(odo):
    return np.array([np.concatenate([f.begin_pose.tr, f.begin_pose.quat,
                                     f.end_pose.tr, f.end_pose.quat])
                     for f in odo.trajectory])


def odometry_checkpoint(group, options, scans, directory, split,
                        reference_checkpoint=None):
    """A run over ``scans`` saved after ``split`` frames and a second
    instance restored from that checkpoint, both carried on to the end;
    with ``reference_checkpoint``, also an instance restored from that
    file (written by the reference after ``split`` frames) and carried
    on. Returns each one's poses and map sizes, and the shard restored
    from the reference's file."""
    a = DistributedOdometry(options, group, device="cpu")
    for xyz, ts in scans[:split]:
        a.register_frame(xyz, ts)
    path = f"{directory}/ckpt.npz"
    a.save_checkpoint(path)
    b = DistributedOdometry(options, group, device="cpu")
    b.load_checkpoint(path)
    runs = {"a": a, "b": b}
    out = {"size_a": a.map_size(), "size_b": b.map_size()}
    if reference_checkpoint is not None:
        c = DistributedOdometry(options, group, device="cpu")
        c.load_checkpoint(reference_checkpoint)
        out["from_reference"] = convert.map_state_to_numpy(
            c.map_state.levels)
        out["from_reference_registered"] = c.registered
        runs["c"] = c
    for xyz, ts in scans[split:]:
        for odo in runs.values():
            odo.register_frame(xyz, ts)
    for key, odo in runs.items():
        out[f"poses_{key}"] = _poses(odo)
        out[f"final_size_{key}"] = odo.map_size()
    return out


def ct_ba_steps(group, state, problem, configs):
    """This rank's slice of a CT-BA window (numpy state / problem of the
    whole window, :func:`ct_ba.shard_problem`) stepped by each config
    (make_ct_ba_step's keyword arguments, ``group`` added): the slice's
    new state and the window's cost."""
    st, pr = convert.ct_ba_from_numpy(state, problem)
    st, pr = ct_ba.shard_problem(st, pr, group)
    out = []
    for cfg in configs:
        step = ct_ba.make_ct_ba_step(group=group, **cfg)
        new, cost = step(st, pr)
        out.append({"state": convert.ct_ba_to_numpy(new),
                    "cost": float(cost)})
    return out


def collectives(group):
    """comm's collectives on the CPU: the halo ring, sums, minimum and
    all_to_all of this rank's values."""
    n, r = comm.size(group), comm.rank(group)
    first = torch.full((3,), float(10 * r + 1))
    last = torch.full((3,), float(10 * r + 2))
    prev_last, next_first = comm.halo(first, last, group)
    s = comm.sum_(torch.tensor([r + 1], dtype=torch.int32), group)
    m = comm.min_(torch.tensor([5.0 - r]), group)
    a2a = comm.all_to_all(
        torch.arange(n, dtype=torch.int32)[:, None] + 100 * r, group)
    return {"prev_last": prev_last.numpy(), "next_first": next_first.numpy(),
            "sum": int(s), "min": float(m), "a2a": a2a.numpy()}



def loaded_modules(group):
    """The top-level packages this rank's process has loaded."""
    import sys
    return sorted({k.split(".")[0] for k, v in sys.modules.items()
                   if v is not None})
