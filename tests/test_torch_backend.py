"""The CT-BA backend of the port (``ct_icp_torch/odometry/backend.py``)
against ct_icp_tpu's, on the CPU (plain versions of K1, K2 and K8).

* The association: on the map the port's stream built (converted to the
  reference's layout), ``make_assemble_fn`` of both packages on the same
  keypoints and poses, and the ``ball_search_moments`` under it on the same
  queries: counts and closest anchors bit for bit; normals up to their sign
  within 1e-4, a2D within 1e-4 and the row weights within rtol 1e-4 plus
  1e-4 of the frame's largest (eigen-solvers and float32 sums in another
  order).
* The keypoints handed to the backend: the streamer's host reconstruction
  (``_host_keypoints``) bit for bit on the same preps, and the per-frame
  path's (the reference hands over its device keypoints) bit for bit on
  their valid rows.
* The driving fixture of tests/test_torch_odometry.py (8 frames, batch 4)
  streamed with the backend on (window 4, period 4) by both packages: equal
  refinement counts and refined keyframes, end poses after
  ``get_trajectory()`` within the 5 mm and 0.05 deg of the other stream
  tests.
* Port only: a refinement dispatched before a rebase and applied after it
  gives the trajectory of the same stream without rebases, within the same
  bound (the reference's streamer handles origins differently by design,
  ROADMAP §C).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.mapping import voxel_map as tvm
from ct_icp_torch.odometry import backend as tbe
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_tpu.mapping import voxel_map as jvm
from ct_icp_tpu.odometry import backend as jbe
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry
from ct_icp_tpu.ops.neighborhood import description_from_moments

from test_torch_odometry import _frames, _jax_options

POSE_ATOL_M = 5e-3
POSE_ATOL_DEG = 0.05
WINDOW = PERIOD = 4


def _backend_options(enabled=True):
    jo = _jax_options()
    jo = dataclasses.replace(jo, backend=dataclasses.replace(
        jo.backend, enabled=enabled, window=WINDOW, period=PERIOD))
    return jo, options_from_dict(dataclasses.asdict(jo))


def _stream_torch(opts, frames, rebase_distance=None):
    odo = TOdometry(opts, device="cpu")
    if rebase_distance is not None:
        odo.rebase_distance = rebase_distance
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
             for i, f in enumerate(frames)]
    summaries = list(odo.stream_frames(iter(preps), batch=4))
    return odo, preps, summaries


def _spy_windows(backend):
    """Record the keyframe ids of every refinement ``backend`` runs."""
    windows = []
    inner = backend._refine

    def refine():
        windows.append([kp[0] for kp in backend._keypoints
                        if kp[0] >= backend.keep_first])
        inner()

    backend._refine = refine
    return windows


@pytest.fixture(scope="module")
def runs():
    frames = _frames()
    jo, to = _backend_options()
    jodo = JOdometry(jo)
    jwin = _spy_windows(jodo.backend)
    jpreps = [jodo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i,
                                 upload=False) for i, f in enumerate(frames)]
    jsum = list(jodo.stream_frames(iter(jpreps), batch=4))
    todo = TOdometry(to, device="cpu")
    twin = _spy_windows(todo.backend)
    tpreps = [todo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
              for i, f in enumerate(frames)]
    tsum = list(todo.stream_frames(iter(tpreps), batch=4))
    return dict(frames=frames, jodo=jodo, jpreps=jpreps, jsum=jsum,
                jwin=jwin, todo=todo, tpreps=tpreps, tsum=tsum, twin=twin,
                jtraj=jodo.get_trajectory(), ttraj=todo.get_trajectory())


def _assert_poses_close(ja, tb):
    assert len(ja) == len(tb)
    for a, b in zip(ja, tb):
        for key in ("begin_pose", "end_pose"):
            pa, pb = getattr(a, key), getattr(b, key)
            assert np.abs(pa.tr - pb.tr).max() < POSE_ATOL_M
            assert pa.angular_distance(pb) < POSE_ATOL_DEG


def test_backend_stream_matches_reference(runs):
    jb, tb = runs["jodo"].backend, runs["todo"].backend
    assert all(s.success for s in runs["tsum"])
    assert tb.refinements == jb.refinements == 2
    assert runs["twin"] == runs["jwin"] == [[2, 3], [4, 5, 6, 7]]
    assert len(tb.refine_ms) == 2
    assert tb.event_waits == 0        # the CPU copies synchronously
    _assert_poses_close(runs["jtraj"], runs["ttraj"])
    # the refinements moved the trajectory: the backend-off stream differs
    _, off = _backend_options(enabled=False)
    odo, _, _ = _stream_torch(off, runs["frames"])
    moved = max(np.abs(a.end_pose.tr - b.end_pose.tr).max()
                for a, b in zip(odo.get_trajectory(), runs["ttraj"]))
    assert moved > 1e-5, moved


def test_host_keypoints_match_reference(runs):
    jodo, todo = runs["jodo"], runs["todo"]
    for jp, tp in zip(runs["jpreps"], runs["tpreps"]):
        k = jp["info"].registered_fid
        jodo._pending_kp[k] = (jp["kp_n"], jp["xyz"], jp["alphas"])
        want = jodo._host_keypoints(k)
        got = todo._keypoint_prefix(tp["kp_n"], tp["xyz"], tp["alphas"])
        assert int(want[2].sum()) == int(tp["kp_n"]) > 0
        for a, b in zip(want, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)


def test_per_frame_keypoints_match_reference():
    """register_frame's summary keypoints: the reference's device arrays
    (the prefix after the residual-cap decimation), the port's host
    reconstruction of the same points."""
    frames = _frames()[:2]
    jo, to = _backend_options(enabled=False)
    jo = dataclasses.replace(jo, ct_icp_options=dataclasses.replace(
        jo.ct_icp_options, max_num_residuals=300))
    to = options_from_dict(dataclasses.asdict(jo))
    jodo, todo = JOdometry(jo), TOdometry(to, device="cpu")
    seen = []
    todo.register_callback(TOdometry.FINISHED_REGISTRATION,
                           lambda odo, s, kp: seen.append(s) or True)
    for f in frames:
        js = jodo.register_frame(f["xyz"], f["timestamps"])
        ts = todo.register_frame(f["xyz"], f["timestamps"])
        assert seen[-1] is ts
        jraw, jal, jvalid = (np.asarray(x) for x in js.keypoints)
        traw, tal, tvalid = ts.keypoints
        np.testing.assert_array_equal(tvalid, jvalid)
        np.testing.assert_array_equal(traw[tvalid], jraw[jvalid])
        np.testing.assert_array_equal(tal[tvalid], jal[jvalid])
        # the residual cap of 300 keeps 450 keypoints (1.5x) of the prefix
        assert int(tvalid.sum()) == 450


def _jax_level(level):
    keys = level.keys.numpy().view(np.uint32)
    count = level.count.numpy()
    return jvm.MapLevel(
        keys=jnp.asarray(keys), count=jnp.asarray(count),
        points=jnp.asarray(level.points.numpy()),
        normals=jnp.asarray(level.normals.numpy()),
        nflags=jnp.asarray(level.nflags.numpy()),
        win=jvm.build_window(jnp.asarray(keys), jnp.asarray(count)),
        num_points=jnp.asarray(int(level.num_points[0]), jnp.int32))


def _window_inputs(todo, tpreps, fids):
    raw, al, valid = (np.stack(x) for x in zip(*(
        todo._keypoint_prefix(tpreps[f]["kp_n"], tpreps[f]["xyz"],
                              tpreps[f]["alphas"]) for f in fids)))
    tr = todo.trajectory
    f32 = np.float32
    poses = [np.stack([getattr(tr[f], k).quat if q else
                       getattr(tr[f], k).tr - todo.origin for f in fids])
             .astype(f32) for k, q in (("begin_pose", True),
                                       ("begin_pose", False),
                                       ("end_pose", True),
                                       ("end_pose", False))]
    ea = np.ones(len(fids), f32)
    for i in range(len(fids) - 1):
        f0, f1 = tr[fids[i]], tr[fids[i + 1]]
        ea[i] = ((f1.begin_pose.timestamp - f0.begin_pose.timestamp)
                 / (f0.end_pose.timestamp - f0.begin_pose.timestamp))
    return raw, al, valid, poses, ea


def test_assembly_matches_reference(runs):
    todo, tpreps = runs["todo"], runs["tpreps"]
    reg = todo.registration
    lvl = reg.level_index
    nv, res = reg.statics.voxel_neighborhood, reg.voxel_resolution
    radius = float(np.float32(reg.search_radius))
    tlevel = todo.map_state[lvl]
    jlevels = tuple(_jax_level(level) for level in todo.map_state)
    raw, al, valid, poses, ea = _window_inputs(todo, tpreps, [4, 5, 6, 7])
    f, k = raw.shape[:2]
    assert 0 < valid.sum() < valid.size        # a padded tail

    # the search on the same queries
    from ct_icp_torch.parallel.ct_ba import interp_world_points
    world = interp_world_points(*(torch.from_numpy(p) for p in poses),
                                torch.from_numpy(raw), torch.from_numpy(al))
    q = world.reshape(-1, 3).numpy()
    qv = valid.reshape(-1)
    jc, jsr, jso, jcl, jcd = jvm.ball_search_moments(
        jlevels[lvl], jnp.asarray(q), jnp.asarray(qv), jnp.float32(radius),
        res, nv=nv)
    desc = description_from_moments(jc, jsr, jso, jnp.asarray(q))
    mom = tvm.ball_search_moments(tlevel, torch.from_numpy(q),
                                  torch.from_numpy(qv), radius, res, nv)
    np.testing.assert_array_equal(mom.count.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(mom.closest.numpy(), np.asarray(jcl))
    live = np.asarray(jc) >= 3
    assert live.mean() > 0.5
    _assert_normals_close(mom.normal.numpy()[live],
                          np.asarray(desc.normal)[live])
    np.testing.assert_allclose(mom.a2d.numpy()[live],
                               np.asarray(desc.a2D)[live], atol=1e-4)

    # the assembled problems
    jprob = jbe.make_assemble_fn(lvl, nv, res, prior_weight=1.5)(
        jlevels, jnp.asarray(raw), jnp.asarray(al), jnp.asarray(valid),
        *(jnp.asarray(p) for p in poses), jnp.float32(radius),
        jnp.asarray(ea))
    tprob = tbe.make_assemble_fn(lvl, nv, res, prior_weight=1.5)(
        todo.map_state, torch.from_numpy(raw), torch.from_numpy(al),
        torch.from_numpy(valid), *(torch.from_numpy(p) for p in poses),
        radius, torch.from_numpy(ea))
    np.testing.assert_array_equal(tprob.anchors.numpy(),
                                  np.asarray(jprob.anchors))
    jw = np.asarray(jprob.weights)
    used = jw > 0
    assert used.sum() > 0.5 * valid.sum()
    _assert_normals_close(tprob.normals.numpy()[used],
                          np.asarray(jprob.normals)[used])
    np.testing.assert_allclose(tprob.weights.numpy(), jw, rtol=1e-4,
                               atol=1e-4 * jw.max())
    for name in ("raw", "alphas", "prior_quat_begin", "prior_tr_end",
                 "prior_weight", "edge_alpha"):
        np.testing.assert_array_equal(getattr(tprob, name).numpy(),
                                      np.asarray(getattr(jprob, name)))


def _assert_normals_close(got, want):
    sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    np.testing.assert_allclose(got * sign, want, atol=1e-4)


def test_refinement_straddling_a_rebase(runs):
    """A rebase at frame 4, after the first window (frames 2, 3) was
    dispatched at frame 3 and before it is applied at frame 7: that window
    comes out exactly as without the rebase (it is applied in its dispatch
    frame). The second window is assembled after the rebase, on the rebuilt
    map, which keeps 873 of its 1,185 rows (the reference's row-level
    rehash drops rows whose shifted first points share a voxel, ROADMAP
    §C): its poses agree within 5 mm and 0.15 deg."""
    _, to = _backend_options()
    odo = TOdometry(to, device="cpu")
    odo.rebase_distance = 0.5
    origins = []
    inner = odo.backend._refine

    def refine():
        origins.append(odo.origin.copy())
        inner()

    odo.backend._refine = refine
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
             for i, f in enumerate(runs["frames"])]
    summaries = list(odo.stream_frames(iter(preps), batch=4))
    assert all(s.success for s in summaries)
    # one window applied, one pending until get_trajectory()
    assert odo.rebases == 1 and odo.backend.refinements == 1
    # the first window was dispatched in one map frame and applied (at the
    # second refine) in another
    assert len(origins) == 2
    assert not origins[0].any() and np.abs(origins[1]).max() > 0.3
    got, want = odo.get_trajectory(), runs["ttraj"]
    assert odo.backend.refinements == 2
    for a, b in zip(got[:4], want[:4]):
        for key in ("begin_pose", "end_pose"):
            np.testing.assert_array_equal(getattr(a, key).tr,
                                          getattr(b, key).tr)
            np.testing.assert_array_equal(getattr(a, key).quat,
                                          getattr(b, key).quat)
    for a, b in zip(got[4:], want[4:]):
        for key in ("begin_pose", "end_pose"):
            pa, pb = getattr(a, key), getattr(b, key)
            assert np.abs(pa.tr - pb.tr).max() < POSE_ATOL_M
            assert pa.angular_distance(pb) < 0.15
