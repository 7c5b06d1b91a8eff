"""DistributedOdometry (ct_icp_torch.parallel.distributed_odometry) on gloo
ranks (comm.spawn, tests/torch_dist_cases.py) against ct_icp_tpu's on a
JAX Mesh of the same size (1, 2 and 4), on the graft entry's shard
invariance check: its options and four 640-point plane-and-walls scans,
in both insert modes.

Each frame's begin and end positions within 5e-3 m of the reference's
(test_torch_odometry.py's single-device bound: float32 sums in another
order move the solver's path by micrometres a frame); n ranks against one
within 0.02 m and 0.2 degrees (the reference's own shard-invariance
bounds, tests/test_distributed_odometry.py:79-80); nothing dropped. A
checkpoint written by the port after two frames restores into a new
instance that carries on bit for bit as the uninterrupted one does, and a
checkpoint the reference wrote restores into the port shard for shard, bit
for bit, and carries on within 5e-3 m of the reference.
"""

import dataclasses

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from ct_icp_torch import convert
from ct_icp_torch.config import options as topt
from ct_icp_torch.parallel import comm
from ct_icp_tpu.config.options import (CTICPOptions,
                                       MultiResolutionVoxelMapOptions,
                                       OdometryOptions, ResolutionParam)
from ct_icp_tpu.parallel.distributed_odometry import DistributedOdometry

RANKS = (1, 2, 4)
MODES = ("broadcast", "partitioned")
POSE_ATOL_M = 5e-3
SHARD_M, SHARD_DEG = 0.02, 0.2

# __graft_entry__.py's dopts
DOPTS = OdometryOptions(
    map_options=MultiResolutionVoxelMapOptions(
        resolutions=(ResolutionParam(0.5, 0.0, 8, 10),),
        default_radius=0.8),
    max_scan_points=1024, max_subsampled_points=1024, max_keypoints=256,
    max_dirty_voxels=256, init_num_frames=2,
    ct_icp_options=CTICPOptions(num_iters_icp=2, ls_max_num_iters=2,
                                min_number_neighbors=3))


def _scans(frames=4):
    """The graft entry's plane and two walls, 640 points, moved 6 cm and
    2 cm a frame, with 5 mm noise."""
    rng = np.random.default_rng(0)
    n = 640
    geom = np.zeros((n, 3), np.float32)
    geom[: n // 2, :2] = rng.uniform(-4, 4, (n // 2, 2))
    geom[n // 2:, 0] = rng.uniform(-4, 4, n - n // 2)
    geom[n // 2:, 2] = rng.uniform(0, 3, n - n // 2)
    geom[n // 2:, 1] = np.where(rng.uniform(size=n - n // 2) < 0.5, -4.0, 4.0)
    ts = np.linspace(0.0, 0.1, n)
    return [(geom + np.array([0.06 * k, 0.02 * k, 0.0])
             + rng.normal(scale=0.005, size=geom.shape), ts + 0.1 * k)
            for k in range(frames)]


def _port_options():
    return convert.options_from_dict(dataclasses.asdict(DOPTS),
                                     topt.OdometryOptions)


def _ref_poses(odo):
    return np.array([np.concatenate([f.begin_pose.tr, f.begin_pose.quat,
                                     f.end_pose.tr, f.end_pose.quat])
                     for f in odo.trajectory])


def _angle_deg(qa, qb):
    d = np.abs(np.sum(qa * qb, -1)) / (np.linalg.norm(qa, axis=-1)
                                       * np.linalg.norm(qb, axis=-1))
    return np.degrees(2.0 * np.arccos(np.clip(d, 0.0, 1.0)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    scans = _scans()
    d = tmp_path_factory.mktemp("store")
    out = {}
    for n in RANKS:
        mesh = Mesh(np.array(jax.devices()[:n]), ("map",))
        ref = {}
        for mode in MODES:
            odo = DistributedOdometry(mesh, DOPTS, map_update=mode)
            for xyz, ts in scans:
                odo.register_frame(xyz, ts)
            ref[mode] = {"poses": _ref_poses(odo),
                         "map_size": odo.map_size(),
                         "dropped": odo.dropped_points}
        port = comm.spawn("torch_dist_cases:odometry_runs", n, d,
                          args=(_port_options(), scans, MODES))
        out[n] = (port, ref)
    return out


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("mode", MODES)
def test_poses_match_reference(runs, n, mode):
    port, ref = runs[n]
    want = ref[mode]["poses"]
    for rank in port:     # every rank holds the same trajectory
        got = rank[mode]["poses"]
        np.testing.assert_array_equal(got, port[0][mode]["poses"])
        np.testing.assert_allclose(got[:, 0:3], want[:, 0:3], rtol=0,
                                   atol=POSE_ATOL_M)
        np.testing.assert_allclose(got[:, 7:10], want[:, 7:10], rtol=0,
                                   atol=POSE_ATOL_M)
        assert rank[mode]["dropped"] == 0 == ref[mode]["dropped"]
    assert port[0][mode]["map_size"] > 1000


@pytest.mark.parametrize("n", RANKS[1:])
@pytest.mark.parametrize("mode", MODES)
def test_ranks_agree_with_one(runs, n, mode):
    got = runs[n][0][0][mode]["poses"]
    one = runs[1][0][0]["broadcast"]["poses"]
    assert np.linalg.norm(got[:, 7:10] - one[:, 7:10], axis=-1).max() \
        < SHARD_M
    assert _angle_deg(got[:, 10:14], one[:, 10:14]).max() < SHARD_DEG


@pytest.mark.parametrize("n", RANKS)
def test_partitioned_map_equals_broadcast(runs, n):
    """Both inserts store the same points: the union of the shards, as a
    sorted set (the reference's _all_shard_points)."""
    def points(mode):
        out = []
        for rank in runs[n][0]:
            lvl = rank[mode]["levels"][0]
            p = lvl["points"].reshape(len(lvl["keys"]), 3, -1)
            p = p.transpose(0, 2, 1)
            live = (lvl["keys"] > 1) & (lvl["count"] > 0)
            cap = (np.arange(p.shape[1])[None, :]
                   < np.where(live, lvl["count"], 0)[:, None])
            out.append(p[cap])
        allp = np.concatenate(out)
        return allp[np.lexsort(allp.T)]
    np.testing.assert_array_equal(points("partitioned"), points("broadcast"))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two ranks: the port's own round trip, and the reference's
    checkpoint (a 2-device mesh after two frames) restored into the port;
    the reference carried on over the same frames."""
    scans = _scans()
    d = tmp_path_factory.mktemp("ckpt")
    mesh = Mesh(np.array(jax.devices()[:2]), ("map",))
    ref = DistributedOdometry(mesh, DOPTS)
    for xyz, ts in scans[:2]:
        ref.register_frame(xyz, ts)
    ref.save_checkpoint(d / "ref.npz")
    shards = [{f: np.asarray(getattr(lvl, f)) for f in lvl._fields}
              for lvl in ref.map_state.levels]
    for xyz, ts in scans[2:]:
        ref.register_frame(xyz, ts)
    port = comm.spawn("torch_dist_cases:odometry_checkpoint", 2, d,
                      args=(_port_options(), scans, str(d / "port"), 2,
                            str(d / "ref.npz")))
    return port, shards, _ref_poses(ref)


def test_checkpoint_round_trip(checkpoints):
    port, _, _ = checkpoints
    for rank in port:
        assert rank["size_a"] == rank["size_b"] > 0
        np.testing.assert_array_equal(rank["poses_b"], rank["poses_a"])
        assert rank["final_size_b"] == rank["final_size_a"]


def test_reference_checkpoint_restores(checkpoints):
    port, shards, ref_poses = checkpoints
    for r, rank in enumerate(port):
        assert rank["from_reference_registered"] == 2
        for got, want in zip(rank["from_reference"], shards):
            np.testing.assert_array_equal(got["keys"],
                                          want["keys"][r].astype(np.uint32))
            for f in ("count", "points", "normals", "nflags"):
                np.testing.assert_array_equal(got[f], want[f][r],
                                              err_msg=f)
        np.testing.assert_allclose(rank["poses_c"][:, 7:10],
                                   ref_poses[:, 7:10], rtol=0,
                                   atol=POSE_ATOL_M)
