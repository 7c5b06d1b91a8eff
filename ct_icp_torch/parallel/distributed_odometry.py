"""Per-frame odometry against a voxel map sharded over a process group (A11).

Counterpart of ``ct_icp_tpu/parallel/distributed_odometry.py``: the map's
voxels are partitioned over the ranks by owner hash
(``parallel/sharded_map.py``), each rank holding its shard on its own
device, and both halves of the per-frame path run distributed:

  * registration: the keypoints are replicated; each ICP iteration computes
    the moments of the rank's own voxels around them (K1 over all
    (2nv+1)^3 voxels, then K2), combines them over the ranks with all_reduce
    sums (``sharded_map.make_sharded_ball_query_fn``), forms the
    descriptors from the combined moments and runs the LM inner loop (K5)
    on every rank alike (identical inputs, identical results);
  * the map update: the broadcast or the partitioned insert of
    ``sharded_map``, each with the reference's ``with_normals`` refit of
    the dirty voxels (K10).

The host loop mirrors the reference's ``DistributedOdometry``: its motion
initialisation, its two K4 sub-samples (``ops/sampling.py``) with the
startup voxel sizes of the init regimen, and its solver, which keeps the
reference's differences from the single-device one: no candidate cache, no
k-NN cap, no residual cap, and an occupancy threshold of 1. Each ICP
iteration reads back once (the convergence test), as
``icp/solver.py::build_register_fn`` does.
"""

import dataclasses
from typing import List

import numpy as np
import torch

from ct_icp_torch import convert, resolve_device
from ct_icp_torch.config.options import OdometryOptions
from ct_icp_torch.core import se3 as s3
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.core.pose import Pose, TrajectoryFrame
from ct_icp_torch.icp import residuals as res
from ct_icp_torch.icp import solver as slv
from ct_icp_torch.icp.registration import make_prior
from ct_icp_torch.kernels import scan_transform as k14
from ct_icp_torch.odometry.odometry import _sanitize_scan
from ct_icp_torch.ops import sampling as smp
from ct_icp_torch.ops.neighborhood import description_from_moments
from ct_icp_torch.parallel import comm
from ct_icp_torch.parallel import sharded_map as sm


def make_distributed_register_fn(statics: slv.SolverStatics, map_options,
                                 group=None):
    """The sharded CT-ICP registration (reference :50-135): register(state,
    raw [K, 3], alphas [K], valid [K], qb, tb, qe, te, prior [14], dyn) ->
    (qb, tb, qe, te, n_res, converged, host reads), the same on every
    rank. ``map_options`` is the map's
    ``MultiResolutionVoxelMapOptions``."""
    query = sm.make_sharded_ball_query_fn(
        map_options, statics.level_index, statics.voxel_neighborhood, group)

    def register(state: sm.ShardedMapState, raw, alphas, valid, qb, tb, qe,
                 te, prior, dyn):
        if not isinstance(dyn, slv.SolverDynamics):
            dyn = slv.unpack_dynamics(dyn)
        qb = s3.quat_normalize(qb)
        qe = s3.quat_normalize(qe)
        n_res = torch.zeros((), dtype=torch.int32, device=raw.device)
        converged = False
        it = syncs = 0
        while it < dyn.num_iters_icp and not converged:
            world = k14.transform(raw, alphas, qb, tb, qe, te)
            count, sum_rel, sum_outer, closest, best = query(
                state, world, valid, dyn.search_radius)
            desc = description_from_moments(count, sum_rel, sum_outer, world)
            ok = valid & (count >= dyn.min_number_neighbors)
            cdist = torch.where(torch.isfinite(best), best,
                                torch.zeros_like(best))
            geom_w = res.ceres_path_weights(
                desc.a2D, cdist, dyn.power_planarity, dyn.weight_alpha,
                dyn.weight_neighborhood, dyn.max_dist_to_plane,
                np.float32(max(dyn.min_number_neighbors, 1)))
            nqb, ntb, nqe, nte, _, n_res, _ = slv._lm_inner_loop(
                statics, dyn, raw, alphas, closest, desc.normal, geom_w, ok,
                qb, tb, qe, te, prior)
            enough = n_res >= dyn.min_number_neighbors
            nqb = torch.where(enough, nqb, qb)
            ntb = torch.where(enough, ntb, tb)
            nqe = torch.where(enough, nqe, qe)
            nte = torch.where(enough, nte, te)
            diff_rot = (s3.angular_distance_deg(qb, nqb)
                        + s3.angular_distance_deg(qe, nqe))
            diff_trans = (torch.linalg.norm(tb - ntb)
                          + torch.linalg.norm(te - nte))
            conv = ((diff_rot < dyn.threshold_orientation_norm)
                    & (diff_trans < dyn.threshold_translation_norm)) \
                | ~enough
            qb, tb, qe, te = nqb, ntb, nqe, nte
            it += 1
            converged = bool(conv)
            syncs += 1
        return (s3.quat_normalize(qb), tb, s3.quat_normalize(qe), te, n_res,
                converged, syncs)

    return register


class DistributedOdometry:
    """Per-frame odometry whose map lies sharded over the ranks of
    ``group`` (``None``: one rank), this rank's shard on ``device`` (the
    card unless the caller asks for the CPU). ``map_update`` picks the
    insert: ``"broadcast"`` (every rank masks the whole scan by ownership)
    or ``"partitioned"`` (each rank packs 1/n of the scan by owner, K11,
    and the ranks exchange it with one all_to_all per level; overflowed
    points are dropped and counted in ``dropped_points``). Both store the
    same map. ``register_frame(xyz, timestamps)`` returns the frame's
    ``TrajectoryFrame``."""

    def __init__(self, options: OdometryOptions, group=None, device=None,
                 map_update: str = "broadcast"):
        if map_update not in ("broadcast", "partitioned"):
            raise ValueError(f"unknown map_update {map_update!r} "
                             "(want 'broadcast' or 'partitioned')")
        self.device = resolve_device(device)
        self.group = group
        self.options = options
        self.map_options = options.map_options
        self.map_update = map_update
        self.map_state = sm.make_sharded_map(self.map_options, group,
                                             self.device)
        self.dropped_points = 0
        if map_update == "partitioned":
            self.update = sm.make_partitioned_update_fn(
                self.map_options, options.max_dirty_voxels, group)
        else:
            self.update = sm.make_sharded_update_fn(
                self.map_options, options.max_dirty_voxels, group)
        level_idx, nv = self.map_options.search_params(
            self.map_options.default_radius)
        icp = options.ct_icp_options
        self.statics = slv.SolverStatics(
            num_keypoints=options.max_keypoints,
            max_neighbors=icp.max_number_neighbors,
            level_index=level_idx, voxel_neighborhood=nv,
            distance=icp.distance, loss=icp.loss_function,
            solver=icp.solver, parametrization=icp.parametrization)
        self.register_fn = make_distributed_register_fn(
            self.statics, self.map_options, group)
        self.search_radius = self.map_options.default_radius
        self.voxel_resolution = self.map_options.resolutions[
            level_idx].resolution
        self.trajectory: List[TrajectoryFrame] = []
        self.registered = 0
        # device->host reads of every register_frame so far
        self.host_syncs = 0

    def _motion_init(self, begin_ts, end_ts) -> TrajectoryFrame:
        k = self.registered
        frame = TrajectoryFrame(Pose(timestamp=begin_ts, frame_id=k),
                                Pose(timestamp=end_ts, frame_id=k))
        if k >= 1:
            prev = self.trajectory[k - 1]
            frame.begin_pose.quat = prev.end_pose.quat.copy()
            frame.begin_pose.tr = prev.end_pose.tr.copy()
            if k >= 2:
                prev2 = self.trajectory[k - 2]
                rel = prev2.end_pose.inverse() * prev.end_pose
                ext = prev.end_pose * rel
                frame.end_pose.quat = ext.quat
                frame.end_pose.tr = ext.tr
            else:
                frame.end_pose.quat = prev.end_pose.quat.copy()
                frame.end_pose.tr = prev.end_pose.tr.copy()
        return frame

    def _f32(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def register_frame(self, xyz: np.ndarray, timestamps: np.ndarray
                       ) -> TrajectoryFrame:
        xyz, timestamps = _sanitize_scan(xyz, timestamps)
        o = self.options
        k = self.registered
        frame = self._motion_init(float(timestamps.min()),
                                  float(timestamps.max()))
        span = frame.end_pose.timestamp - frame.begin_pose.timestamp
        alphas = ((timestamps - frame.begin_pose.timestamp)
                  / (span if span > 0 else 1.0)).astype(np.float32)
        raw = self._f32(xyz)
        al = self._f32(np.clip(alphas, 0.0, 1.0))
        valid = torch.ones(raw.shape[0], dtype=torch.bool,
                           device=self.device)

        # the voxel sub-sample and the keypoints (K4 twice); the init
        # regimen takes the finer startup voxel sizes (reference
        # odometry.cpp:339, 560-565)
        startup = k < o.init_num_frames
        vsz = o.init_voxel_size if startup else o.voxel_size
        ssz = o.init_sample_voxel_size if startup else o.sample_voxel_size
        idx, ok, _ = smp.voxel_subsample_indices(raw, valid, vsz,
                                                 o.max_subsampled_points)
        idx = idx.long()
        sub_raw, sub_al, sub_ok = raw[idx], al[idx], ok
        kidx, kok, _ = smp.voxel_subsample_indices(sub_raw, sub_ok, ssz,
                                                   o.max_keypoints)
        kidx = kidx.long()
        kp_raw, kp_al, kp_ok = sub_raw[kidx], sub_al[kidx], kok

        syncs = 0
        if k > 0:
            prior = make_prior(self.trajectory[k - 1],
                               o.default_motion_model, np.zeros(3))
            opts = o.ct_icp_options
            if k < o.init_num_frames:
                # the init regimen (reference odometry.cpp:560-565)
                opts = dataclasses.replace(
                    opts, threshold_voxel_occupancy=1,
                    num_iters_icp=max(opts.num_iters_icp, 15))
            dyn = slv.pack_dynamics(opts, self.search_radius,
                                    self.voxel_resolution)
            qb, tb, qe, te, _, _, syncs = self.register_fn(
                self.map_state, kp_raw, kp_al, kp_ok,
                self._f32(frame.begin_pose.quat),
                self._f32(frame.begin_pose.tr),
                self._f32(frame.end_pose.quat), self._f32(frame.end_pose.tr),
                self._f32(prior), dyn)
            packed = torch.cat([qb, tb, qe, te]).double().cpu().numpy()
            syncs += 1
            frame.begin_pose.quat = s3n.quat_normalize(packed[0:4])
            frame.begin_pose.tr = packed[4:7]
            frame.end_pose.quat = s3n.quat_normalize(packed[7:11])
            frame.end_pose.tr = packed[11:14]

        # the world points and the sharded insert
        begin_tr = self._f32(frame.begin_pose.tr)
        world = k14.transform(
            sub_raw, sub_al, self._f32(frame.begin_pose.quat), begin_tr,
            self._f32(frame.end_pose.quat), self._f32(frame.end_pose.tr))
        location = self._f32(frame.end_pose.tr)
        if self.map_update == "partitioned":
            self.map_state, _, dropped = self.update(
                self.map_state, world, sub_ok, begin_tr, location,
                o.max_distance)
            self.dropped_points += int(dropped)
            syncs += 1
        else:
            self.map_state, _ = self.update(
                self.map_state, world, sub_ok, begin_tr, location,
                o.max_distance)
        # each level's dirty list is read back once (voxel_map.insert_points)
        self.host_syncs += syncs + len(self.map_state.levels)
        self.trajectory.append(frame)
        self.registered += 1
        return frame

    def map_size(self) -> int:
        """The points stored over every rank and level (a collective)."""
        total = torch.zeros((1,), dtype=torch.int64, device=self.device)
        for level in self.map_state.levels:
            total += level.count.sum(dtype=torch.int64)
        return int(comm.sum_(total, self.group))

    # ------------------------------------------------------ checkpointing —
    def save_checkpoint(self, path) -> None:
        """Write the whole distributed state (every rank's shard, gathered
        on rank 0, and the trajectory) in the reference's layout: an .npz
        with a leading shard axis on every ``level{i}_*`` field and a
        ``.meta.json``. A collective: every rank calls it, rank 0 writes.
        The owner hash depends on the shard count, so it restores onto the
        same number of ranks."""
        mine = convert.map_state_to_numpy(self.map_state.levels)
        n = comm.size(self.group)
        if n > 1:
            shards = [None] * n
            torch.distributed.all_gather_object(shards, mine,
                                                group=self.group)
        else:
            shards = [mine]
        if comm.rank(self.group) == 0:
            convert.write_sharded_checkpoint(
                path, shards, self.trajectory, self.registered)
        if n > 1:
            torch.distributed.barrier(group=self.group)

    def load_checkpoint(self, path) -> None:
        """Restore what :meth:`save_checkpoint` (or the reference's) wrote:
        this rank takes its row of every field."""
        levels, trajectory, meta = convert.read_sharded_checkpoint(path)
        n = comm.size(self.group)
        if meta["num_shards"] != n:
            raise ValueError(
                f"checkpoint has {meta['num_shards']} shards, the group has "
                f"{n} (owner-hash partitions are shard-count specific)")
        self.map_state = sm.ShardedMapState(
            levels=convert.sharded_map_from_numpy(
                levels, comm.rank(self.group), self.device))
        self.trajectory = trajectory
        self.registered = meta["registered"]
