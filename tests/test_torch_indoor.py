"""The indoor walk's slice: ct_icp_torch (CPU, plain kernel versions)
against ct_icp_tpu with ``default_robust_outdoor_low_inertia()``, the
port's first three-level map.

The profile's three levels (0.2 m x 50 points, 0.5 m x 40, 1.5 m x 40) cut
to 2^14 / 2^13 / 2^12 slots and the scans to 12,000 points, with scan and
sub-sample caps of 16,384 that cut nothing, as the profile's 2^17 and 2^16
cut nothing of the walk's 60,000-point scans. The frames are the indoor
walk's from frame 18 on (seed 7), so that a short stream reaches the first
doorway turn (4.6-5.6 degrees a frame from frame 21), where the profile's
2-degree robust thresholds escalate. Here: the options carried across, the
gate's constants and frames against ``bench.py``'s, the map frame 0
leaves, bit for bit on every level, and, with a sub-sample cap that cuts
scans, the points each package keeps and elects. The short robust stream
is ``test_torch_indoor_stream.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bench
import jax.numpy as jnp
from ct_icp_torch.config import options as topt
from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.datasets import indoor_walk as iw
from ct_icp_torch.evaluation import kitti as tkitti
from ct_icp_torch.odometry import pipeline as tpl
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_torch.ops import sampling as tsmp
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.config import yaml_config as jyc
from ct_icp_tpu.evaluation import kitti as jkitti
from ct_icp_tpu.odometry import pipeline as jpl
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry
from ct_icp_tpu.ops import sampling as jsmp

FIRST_FRAME = 18
POINTS = 12000
LEVELS = ((0.2, 0.03, 50, 14), (0.5, 0.1, 40, 13), (1.5, 0.15, 40, 12))


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One torch thread: the plain kernels' small ops run about as fast,
    and the cores stay free for the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def indoor_options() -> jopt.OdometryOptions:
    """The low-inertia profile, its three levels and capacities cut."""
    d = jopt.default_robust_outdoor_low_inertia()
    return dataclasses.replace(
        d, map_options=dataclasses.replace(
            d.map_options, resolutions=tuple(
                jopt.ResolutionParam(*r) for r in LEVELS)),
        max_scan_points=16384, max_subsampled_points=16384,
        max_keypoints=1024, max_dirty_voxels=4096, init_num_frames=4)


def indoor_frames(n):
    """Frames FIRST_FRAME .. FIRST_FRAME + n - 1 of the indoor walk (seed 7)
    at POINTS points a frame."""
    acq = iw.load_acquisition(iw.INDOOR_SEEDS[0])
    acq.options = dataclasses.replace(acq.options,
                                      num_points_per_frame=POINTS)
    return [acq.frame(FIRST_FRAME + i) for i in range(n)]


def stream_both(jo, frames, batch=4):
    """Both packages stream ``frames``: (odometry, summaries) of each."""
    jodo = JOdometry(jo)
    todo = TOdometry(options_from_dict(dataclasses.asdict(jo)), device="cpu")
    out = []
    for odo, kw in ((jodo, {"upload": False}), (todo, {})):
        preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i,
                                   **kw) for i, f in enumerate(frames)]
        out.append((odo, list(odo.stream_frames(iter(preps), batch=batch))))
    return out


def test_low_inertia_options_carry_across():
    """convert.py carries the profile across whole: its three levels and
    what only this profile sets."""
    jo = jopt.default_robust_outdoor_low_inertia()
    to = options_from_dict(dataclasses.asdict(jo))
    assert to == topt.default_robust_outdoor_low_inertia()
    assert to.map_options.resolutions == (
        topt.ResolutionParam(0.2, 0.03, 50, 20),
        topt.ResolutionParam(0.5, 0.1, 40, 19),
        topt.ResolutionParam(1.5, 0.15, 40, 17))
    # searched on level 1 (radius 0.8 over 0.5 m voxels, nv 2)
    assert to.map_options.search_params(to.map_options.default_radius) == \
        (1, 2)
    icp = to.ct_icp_options
    assert to.initialization == topt.Initialization.INIT_NONE
    assert to.default_motion_model.beta_small_velocity == 0.001
    assert icp.weighting_scheme == topt.WeightingScheme.ALL
    assert (icp.weight_alpha, icp.weight_neighborhood) == (0.8, 0.2)
    assert (icp.min_num_residuals, icp.max_num_residuals) == (200, 600)
    assert (icp.num_iters_icp, icp.ls_max_num_iters) == (30, 10)
    assert (to.robust_empty_voxel_threshold, to.robust_num_attempts) == \
        (0.1, 3)
    assert (to.robust_threshold_relative_orientation,
            to.robust_threshold_ego_orientation) == (2.0, 2.0)
    cut = options_from_dict(dataclasses.asdict(indoor_options()))
    assert [r.capacity_log2 for r in cut.map_options.resolutions] == \
        [14, 13, 12]


def test_indoor_gate_matches_bench():
    """ct_icp_torch/tools/bench.py --indoor's own copies of the gate: the
    bounds, seeds, scene file, frames and batch of bench.py::run_indoor,
    the INDOOR segment lengths, and the scene's frames bit for bit (a
    doorway-turn frame, sway and bob included)."""
    assert (iw.INDOOR_TR_BOUND_PCT, iw.INDOOR_APE_BOUND_M, iw.INDOOR_SEEDS,
            iw.INDOOR_CONFIG) == (bench.INDOOR_TR_BOUND_PCT,
                                  bench.INDOOR_APE_BOUND_M,
                                  bench.INDOOR_SEEDS, bench.INDOOR_CONFIG)
    # bench.py::run_indoor: num_frames or 240, BENCH_BATCH default "4"
    assert (iw.INDOOR_FRAMES, iw.INDOOR_BATCH) == (240, 4)
    assert tkitti.INDOOR_SEGMENT_LENGTHS == jkitti.INDOOR_SEGMENT_LENGTHS
    seed = iw.INDOOR_SEEDS[1]
    t_acq = iw.load_acquisition(seed)
    j_acq = jyc.synthetic_sequence_from_yaml(str(iw.config_path()),
                                             seed=seed).acq
    assert t_acq.num_frames() == j_acq.num_frames() > iw.INDOOR_FRAMES
    for i in (0, 23):
        a, b = t_acq.frame(i), j_acq.frame(i)
        np.testing.assert_array_equal(a["xyz"], b["xyz"])
        np.testing.assert_array_equal(a["timestamps"], b["timestamps"])
        for key in ("begin_pose", "end_pose"):
            np.testing.assert_array_equal(a[key].quat, b[key].quat)
            np.testing.assert_array_equal(a[key].tr, b[key].tr)
    assert a["xyz"].shape[0] == 60000


def test_three_level_map_after_frame_0_matches_reference():
    """Frame 0 inserted into all three levels (each at its own resolution
    and min distance): keys, counts, rows and num_points bit for bit."""
    (jodo, _), (todo, _) = stream_both(indoor_options(), indoor_frames(1))
    assert len(todo.map_state) == len(jodo.map_state.levels) == 3
    for tl, jl in zip(todo.map_state, jodo.map_state.levels):
        np.testing.assert_array_equal(tl.keys.numpy(),
                                      np.asarray(jl.keys).view(np.int32))
        np.testing.assert_array_equal(tl.count.numpy(), np.asarray(jl.count))
        np.testing.assert_array_equal(tl.points.numpy(),
                                      np.asarray(jl.points))
        np.testing.assert_array_equal(tl.num_points.numpy(),
                                      np.asarray(jl.num_points).reshape(-1))
    sizes = [int(lv.num_points[0]) for lv in todo.map_state]
    # every level holds the frame; the 1.5 m level the fewest points
    assert min(sizes) == sizes[2] > 1000


def test_cut_subsample_matches_reference():
    """A sub-sample cap of 8,192 cuts stream frames 0 and 3 (8,271 and
    8,248 points after the dedup). Both packages keep the same points of
    every frame (the prepared scan, its wire packing and keypoint prefix,
    bit for bit), and the escalated attempt's device election (1.0 m, the
    keypoint capacity) on each cut frame's unpacked sub-sample keeps the
    same indices: where the cap cuts, the inputs of registration agree, and
    only the solver's float32 sums can move the poses."""
    jo = dataclasses.replace(indoor_options(), max_subsampled_points=8192)
    to = options_from_dict(dataclasses.asdict(jo))
    jodo, todo = JOdometry(jo), TOdometry(to, device="cpu")
    voxel = max(to.sample_voxel_size / 1.5,
                min(to.init_voxel_size, to.voxel_size))
    cut = []
    for i, f in enumerate(indoor_frames(4)):
        jp = jodo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i,
                                upload=False)
        tp = todo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
        assert (tp["n"], tp["kp_n"], tp["kp_voxel"]) == \
            (jp["n"], jp["kp_n"], jp["kp_voxel"])
        for key in ("xyz", "timestamps", "alphas", "scan_host"):
            np.testing.assert_array_equal(tp[key], jp[key])
        n = tp["n"]
        if n < to.max_subsampled_points:
            continue
        cut.append(i)
        jraw, _ = jpl.unpack_scan(jnp.asarray(jp["scan_host"].view(np.int16)))
        traw, _ = tpl.unpack_scan(torch.from_numpy(
            tp["scan_host"].view(np.int16)))
        jraw, traw = np.asarray(jraw)[:n], traw[:n]
        np.testing.assert_array_equal(traw.numpy(), jraw)
        ji, jv, jc = jsmp.voxel_subsample_indices(
            jnp.asarray(jraw), jnp.ones(n, bool), voxel, to.max_keypoints)
        ti, tv, tc = tsmp.voxel_subsample_indices(
            traw, torch.ones(n, dtype=torch.bool), voxel, to.max_keypoints)
        assert int(tc) == int(jc) > 0
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert cut == [0, 3]
