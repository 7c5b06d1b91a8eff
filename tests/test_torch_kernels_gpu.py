"""CUDA kernels K1-K13 against their plain PyTorch versions, on the card
(K5 as one launch per LM call, K3 as one launch per insert, K1 one launch a
call returning slots, K2 reading the live points through them, the rebase
as one K7 and one K6 launch, K4 one launch a call on a claim table kept
from call to call, K8 one launch per CT-BA step (its inner iterations in
one launch), K9 one launch an eviction of every level on per-device
accumulators it leaves zero, K10 one launch a level's normal refit, K12
one launch a k-NN search, K11 one launch an owner pack; K1 with the
normal filter, K2 with a radius a query; K13 one launch an exact sample,
bit for bit, on a table kept from call to call, and the staged path's
register_frame through K13 and K4 and no plain version). The tests that
count a call's device operations read torch.profiler in a fresh process
(the ``traced_ops`` fixture).

Needs an NVIDIA GPU and nvcc (the kernels build from ct_icp_torch/csrc at
first use); skips elsewhere. Run on a machine with the card (this file needs
no JAX, so skip the repo conftest that pins JAX to the CPU):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

Tolerances are those of ct_icp_torch/kernels/checks.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.kernels import build, checks
from ct_icp_torch.kernels import candidate_gather as k1
from ct_icp_torch.kernels import ct_ba_block as k8
from ct_icp_torch.kernels import evict_voxels as k9
from ct_icp_torch.kernels import exact_sample as k13
from ct_icp_torch.kernels import grid_sample as k4
from ct_icp_torch.kernels import knn_search as k12
from ct_icp_torch.kernels import level_normals as k10
from ct_icp_torch.kernels import lm_step as k5
from ct_icp_torch.kernels import map_insert as k3
from ct_icp_torch.kernels import owner_pack as k11
from ct_icp_torch.kernels import plane_moments as k2
from ct_icp_torch.kernels import rebuild as k7
from ct_icp_torch.kernels import row_gather as k6
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.parallel import ct_ba
from torch_rebase_cases import chain_level, merge_level

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def traced_ops():
    """The device operations' names of one ``fn(*args)`` call, traced by
    torch.profiler in a process whose first trace is recent
    (``tools/timing.py::fresh_process_traces``, on this process's tensors):
    on some of the card's machines a process's traces lose their kernels
    from about 10 s after its first one (PERF.md §6). The first of up to
    ten traces that saw the device counts; None where none did."""
    from ct_icp_torch.tools import timing

    def ops(fn, *args):
        ((names, _traces),) = timing.fresh_process_traces(
            [("ops", fn, args, None)])
        return names

    yield ops
    timing.end_fresh_process()


def _scene(rng, n):
    """Ground + two walls, like a street corridor."""
    g = np.stack([rng.uniform(-20, 20, n), rng.uniform(-10, 10, n),
                  rng.normal(scale=0.02, size=n)], -1)
    w = np.stack([rng.uniform(-20, 20, n), np.where(rng.uniform(size=n) < .5,
                                                    -10.0, 10.0),
                  rng.uniform(0, 6, n)], -1)
    return np.concatenate([g, w]).astype(np.float32)


def _warm_level(rng, dev, cap_log2=14, p=30, res=0.8, noise=0.0):
    """A level holding the scene's points, each coordinate moved by normal
    noise of ``noise`` m when given (the walls are exact planes without
    it)."""
    level = vm.make_level(cap_log2, p, dev)
    scene = _scene(rng, 20000)
    if noise:
        scene = scene + rng.normal(scale=noise, size=scene.shape).astype(
            np.float32)
    pts = torch.from_numpy(scene).to(dev)
    ok = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    vm.insert_points(level, pts, ok, res, 0.1, max_rounds=12)
    return level


@pytest.mark.parametrize("nv", [1, 2])
def test_candidate_gather_matches_plain(cuda, nv):
    rng = np.random.default_rng(0)
    level = _warm_level(rng, cuda)
    q = torch.from_numpy(_scene(rng, 600)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=q.shape[0]) < 0.9).to(cuda)
    launches = k1.launches
    for thr in (1, 5):
        checks.check_candidate_gather(level, q, valid, 0.8, nv, thr)
    assert k1.launches == launches + 2          # one launch a call


@pytest.mark.parametrize("max_candidates", [48, 10])
def test_candidate_gather_compaction_matches_plain(cuda, max_candidates):
    """The robust profile's search: 0.5 m voxels, nv = 2 (125 voxels) kept
    down to max_candidates, in one launch."""
    rng = np.random.default_rng(3)
    level = _warm_level(rng, cuda, p=40, res=0.5)
    q = torch.from_numpy(_scene(rng, 600)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=q.shape[0]) < 0.9).to(cuda)
    launches = k1.launches
    for thr in (1, 5):
        checks.check_candidate_gather(level, q, valid, 0.5, 2, thr,
                                      max_candidates)
    assert k1.launches == launches + 2


@pytest.mark.parametrize("k_nearest", [40, 0, None])
def test_plane_moments_matches_plain(cuda, k_nearest):
    rng = np.random.default_rng(1)
    level = _warm_level(rng, cuda)
    q = torch.from_numpy(_scene(rng, 700)).to(cuda)
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=cuda)
    slots, cnt = vm.gather_candidate_planes(level, q, valid, 0.8, 1)
    checks.check_plane_moments(level.points, slots, cnt, q, 0.75, k_nearest)
    cached = torch.full((q.shape[0],), 0.3, device=cuda)
    if k_nearest is not None:
        checks.check_plane_moments(level.points, slots, cnt, q + 0.02, 0.75,
                                   k_nearest, cached)


@pytest.mark.parametrize("max_candidates", [48, 10])
def test_plane_moments_after_compaction_matches_plain(cuda, max_candidates):
    """K2 on the robust search's kept voxels (P = 40), fresh and cached."""
    rng = np.random.default_rng(4)
    level = _warm_level(rng, cuda, p=40, res=0.5)
    q = torch.from_numpy(_scene(rng, 700)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=q.shape[0]) < 0.9).to(cuda)
    slots, cnt = vm.gather_candidate_planes(level, q, valid, 0.5, 2,
                                            max_candidates=max_candidates)
    checks.check_plane_moments(level.points, slots, cnt, q, 0.8, 20)
    want = k2.plane_moments_plain(level.points, slots, cnt, q, 0.8, 20)
    checks.check_plane_moments(level.points, slots, cnt, q + 0.02, 0.8, 20,
                               want.r_eff2)


def _dense_pairs(rng, dev, p=40, o=48, m=64):
    """A table of random full rows and m queries of o candidates each."""
    pts = torch.from_numpy(rng.normal(scale=0.3, size=(256, 3 * p))
                           .astype(np.float32)).to(dev)
    slots = torch.from_numpy(rng.integers(0, 256, (m, o))
                             .astype(np.int32)).to(dev)
    cnt = torch.full((m, o), p, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.normal(scale=0.1, size=(m, 3))
                         .astype(np.float32)).to(dev)
    return pts, slots, cnt, q


@pytest.mark.parametrize("k_nearest", [20, 0, None])
def test_plane_moments_dense_query(cuda, k_nearest):
    """Every candidate full: 48 x 40 = 1,920 live points a query, far past
    what a lane keeps in registers."""
    pts, slots, cnt, q = _dense_pairs(np.random.default_rng(8), cuda)
    assert int(cnt[0].sum()) == 1920
    for radius in (0.75, 2.0):
        checks.check_plane_moments(pts, slots, cnt, q, radius, k_nearest)


@pytest.mark.parametrize("live", [0, 1, 7, 9, 15, 17, 31, 33])
def test_plane_moments_live_counts(cuda, live):
    """Live counts around the group width (G - 1, G + 1 for G = 8, 16 and
    32) and 0, spread over the candidates in several ways."""
    rng = np.random.default_rng(live)
    pts, slots, _, q = _dense_pairs(rng, cuda)
    m, o = slots.shape
    cnt = np.zeros((m, o), np.int32)
    for i in range(m):
        left = live
        for c in rng.permutation(o):
            if left == 0:
                break
            take = int(min(left, rng.integers(1, 41)))
            cnt[i, c] = take
            left -= take
    cnt = torch.from_numpy(cnt).to(cuda)
    assert (cnt.sum(1) == live).all()
    for k_nearest in (20, None):
        checks.check_plane_moments(pts, slots, cnt, q, 0.75, k_nearest)


def test_plane_moments_no_candidate_takes_candidate_zero(cuda):
    """No in-radius point: the closest is point 0 of candidate 0, whether
    its voxel is absent (slot 0) or present but unusable (a real slot)."""
    rng = np.random.default_rng(3)
    level = _warm_level(rng, cuda, p=40, res=0.5)
    q = torch.tensor([[100.0, 0.0, 0.0], [2.3, 1.3, 1.1], [0.5, 0.2, 0.1]],
                     device=cuda)
    valid = torch.tensor([True, False, True], device=cuda)
    for max_candidates in (0, 48):
        slots, cnt = vm.gather_candidate_planes(
            level, q, valid, 0.5, 2, max_candidates=max_candidates)
        assert int(slots[0, 0]) == 0 and int(cnt[:2].sum()) == 0
        checks.check_plane_moments(level.points, slots, cnt, q, 0.8, 20)
        got = k2.plane_moments(level.points, slots, cnt, q, 0.8, 20)
        torch.cuda.synchronize()
        rows = level.points[slots[:2, 0].long()]
        assert torch.equal(got.closest[:2], rows[:, [0, 40, 80]])
        assert (got.count[:2] == 0).all()


@pytest.mark.parametrize("max_rounds", [4, 12])
def test_map_insert_matches_plain(cuda, max_rounds):
    rng = np.random.default_rng(2)
    level = _warm_level(rng, cuda, cap_log2=12)   # ~loaded: long probe chains
    pts = torch.from_numpy(_scene(rng, 8000)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=pts.shape[0]) < 0.95).to(cuda)
    out = checks.check_map_insert(level, pts, valid, 0.8, 0.1, max_rounds)
    assert out["inserted"] > 0
    vm.prune_level(level, torch.zeros(3, device=cuda), 8.0)
    out = checks.check_map_insert(level, pts + 0.05, valid, 0.8, 0.1,
                                  max_rounds)
    assert out["inserted"] > 0


@pytest.mark.parametrize("max_rounds", [4, 12])
@pytest.mark.parametrize("case", ["empty", "cruise", "crowded"])
def test_map_insert_one_launch_matches_plain(cuda, case, max_rounds):
    """The one-launch insert bit for bit: an empty map (every point
    claims), a cruise frame (a warm map, most points resolved by the
    lookup) and a 2^8 table crowded past its probe chains, with tombstones
    from prune_level (several claim rounds; some points stay unresolved)."""
    rng = np.random.default_rng(5)
    if case == "empty":
        level = vm.make_level(14, 30, cuda)
        pts = _scene(rng, 6000)
    elif case == "cruise":
        level = _warm_level(rng, cuda)
        pts = _scene(rng, 6000) + np.float32(0.03)
    else:
        level = _warm_level(rng, cuda, cap_log2=8)
        vm.prune_level(level, torch.zeros(3, device=cuda), 12.0)
        assert int((level.keys == 1).sum()) > 0          # tombstones
        pts = _scene(rng, 3000)
    pts = torch.from_numpy(pts).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=pts.shape[0]) < 0.95).to(cuda)
    launches = k3.launches
    for _ in range(2):      # the second call runs on the first's stamps
        out = checks.check_map_insert(level, pts, valid, 0.8, 0.1,
                                      max_rounds)
        assert out["inserted"] > 0
        vm.insert_points(level, pts, valid, 0.8, 0.1, max_rounds)
        pts = pts + 0.05
    assert k3.launches == launches + 4


@pytest.mark.parametrize("max_rounds", [4, 12])
def test_map_insert_across_stamp_wrap(cuda, max_rounds):
    """Inserts on either side of the claim stamp's wrap, bit for bit. The
    stamp starts just below its limit: the first call ends past it, so the
    second finds claim words whose stamps beat every stamp after the wrap
    (the first call's election words lie on the slots it claims again),
    clears them and starts again from stamp 0."""
    rng = np.random.default_rng(13)
    level = _warm_level(rng, cuda, cap_log2=12)
    mine = [t.clone() for t in (level.keys, level.count, level.points,
                                level.num_points)]
    ref = [t.clone() for t in mine]
    # the kernel's own buffers: map_insert keys them by its points' device
    claim, ctrl = k3._claim_buffers(level.keys.device, level.capacity)
    limit = build.launcher("map_insert", "k3_stamp_limit", ())()
    per_call = k3.MAX_PROBES + max_rounds
    start = limit - per_call + 1

    def stamps():      # the stamp of each claim word (0: all ones)
        return 0xFFFFFFFF - ((claim >> 32) & 0xFFFFFFFF)

    ctrl[0] = start
    for call, after in enumerate((limit + 1, per_call, 2 * per_call)):
        if call == 1:
            assert int((stamps() >= start).sum()) > 0
        pts = torch.from_numpy(_scene(rng, 3000)).to(cuda)
        valid = torch.from_numpy(rng.uniform(size=pts.shape[0]) < 0.95).to(
            cuda)
        n_a = k3.map_insert(*mine, pts, valid, 0.8, 0.1, max_rounds)
        n_b = k3.map_insert_plain(*ref, pts, valid, 0.8, 0.1, max_rounds)
        torch.cuda.synchronize()
        for x, y in zip(mine + [n_a], ref + [n_b]):
            assert torch.equal(x, y)
        assert int(n_a[0]) > 0
        assert int(ctrl[0]) == after
        if call == 1:
            assert int(stamps().max()) < per_call


@pytest.mark.parametrize("table_log2, capacity, n, frac", [
    (22, 4096, 65536, 0.97), (22, 512, 20000, 0.97), (21, 1024, 4096, 0.97),
    (10, 4096, 3000, 0.97), (22, 4096, 0, 0.97),
    (22, 4096, 5000, 0.0),          # every point invalid
    (22, 100, 16766, 0.97),         # kept far past the capacity
    (21, 4096, 1001, 0.97),         # N not a multiple of a block
    (22, 4096, 257, 1.0), (22, 0, 3000, 0.97)])
def test_grid_sample_matches_plain(cuda, table_log2, capacity, n, frac):
    """Bit for bit, and one launch a call."""
    rng = np.random.default_rng(table_log2 + n)
    pts = torch.from_numpy(_scene(rng, max(n // 2, 1))[:n]).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=pts.shape[0]) < frac).to(cuda)
    launches = k4.launches
    out = checks.check_grid_sample(pts, valid, 1.0, capacity, table_log2)
    assert k4.launches == launches + 1
    assert out["count"] > 0 or n == 0 or frac == 0.0 or capacity == 0
    if capacity == 100:
        assert out["count"] == capacity


def test_grid_sample_repeated_calls_on_one_table(cuda):
    """Calls that alternate the table size (22 / 21) and the points, each
    bit for bit: every call takes the next stamp of its table, and the
    words earlier calls left in it never win."""
    rng = np.random.default_rng(4)
    stamps = {}
    for call in range(8):
        t_log2 = 22 if call % 2 == 0 else 21
        pts = torch.from_numpy(_scene(rng, 6000) + np.float32(0.1 * call)).to(
            cuda)
        valid = torch.from_numpy(rng.uniform(size=pts.shape[0]) < 0.95).to(
            cuda)
        out = checks.check_grid_sample(pts, valid, 1.0, 4096, t_log2)
        assert out["count"] > 0
        # the wrapper keys its tables by the points' device (cuda:0)
        _, ctrl, _ = k4._tables[(pts.device, t_log2)]
        stamps.setdefault(t_log2, []).append(int(ctrl[0]))
    for seq in stamps.values():
        assert np.all(np.diff(seq) == 1), stamps


def test_grid_sample_across_stamp_wrap(cuda):
    """Calls on either side of the stamp's wrap, bit for bit. The last
    stamp starts two below its limit: the first two calls take the last
    stamps, leaving words whose stamps beat every stamp after the wrap;
    the third call clears the table and starts again from stamp 1, so only
    its own words are left."""
    rng = np.random.default_rng(21)
    t_log2 = 12                 # a small table: the words left are counted
    word_bits = 32 - int(np.log2(build.launcher(
        "grid_sample", "k4_max_points", ())()))
    limit = build.launcher("grid_sample", "k4_stamp_limit", ())()
    # the wrapper keys its tables by the points' device (cuda:0)
    dev = torch.empty(1, device=cuda).device
    table, ctrl, _ = k4._device_state(dev, t_log2, k4._constants()[1])
    ctrl[0] = limit - 2

    def stamps():           # the stamp of each word (0: cleared)
        hi = (table.to(torch.int64) & 0xFFFFFFFF) >> (32 - word_bits)
        return (1 << word_bits) - 1 - hi

    for call, after in enumerate((limit - 1, limit, 1, 2)):
        pts = torch.from_numpy(_scene(rng, 3000)).to(cuda)
        valid = torch.from_numpy(rng.uniform(size=pts.shape[0]) < 0.95).to(
            cuda)
        out = checks.check_grid_sample(pts, valid, 1.0, 1024, t_log2)
        assert out["count"] > 0
        assert int(ctrl[0]) == after
        if call == 1:
            assert int((stamps() == limit - 1).sum()) > 0
        if call == 2:
            s = stamps()
            assert set(torch.unique(s).tolist()) <= {0, 1}


def test_grid_sample_is_one_device_operation(cuda, traced_ops):
    """A call is one device operation: the kernel, no memset or copy
    (traced in a fresh process)."""
    rng = np.random.default_rng(8)
    pts = torch.from_numpy(_scene(rng, 8000)).to(cuda)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=cuda)
    k4.grid_sample(pts, valid, 1.0, 4096)           # warm-up
    torch.cuda.synchronize()
    names = traced_ops(k4.grid_sample, pts, valid, 1.0, 4096)
    if not names:
        pytest.skip("the profiler saw no device activity")
    assert len(names) == 1 and "grid_sample" in names[0], names


def test_map_insert_three_levels_restore_and_reinsert(cuda):
    """The low-inertia profile's three levels (0.2 m x 50 points at 2^20
    slots, 0.5 m x 40 at 2^19, 1.5 m x 40 at 2^17), each with its own
    claim words: a frame inserted into all three, a checkpoint, a second
    frame, the rollback to the checkpoint and the second frame inserted
    again; keys, counts, rows and num_points bit for bit with the plain
    version at every step."""
    rng = np.random.default_rng(17)
    levels = ((0.2, 0.03, 50, 20), (0.5, 0.1, 40, 19), (1.5, 0.15, 40, 17))
    mine = [vm.make_level(c, p, cuda) for _, _, p, c in levels]
    ref = [vm.make_level(c, p, cuda) for _, _, p, c in levels]
    frames = [torch.from_numpy(_scene(rng, 12000) + np.float32(d)).to(cuda)
              for d in (0.0, 0.07)]
    ok = torch.ones(frames[0].shape[0], dtype=torch.bool, device=cuda)

    def insert(frame):
        for a, b, (res, md, _, _) in zip(mine, ref, levels):
            n_a = vm.insert_points(a, frame, ok, res, md, 12)
            n_b = k3.map_insert_plain(b.keys, b.count, b.points,
                                      b.num_points, frame, ok, res, md, 12)
            torch.cuda.synchronize()
            assert torch.equal(n_a, n_b) and int(n_a[0]) > 0
            for x, y in zip((a.keys, a.count, a.points, a.num_points),
                            (b.keys, b.count, b.points, b.num_points)):
                assert torch.equal(x, y)

    launches = k3.launches
    insert(frames[0])
    saved = [vm.MapLevel(*(t.clone() for t in lv)) for lv in mine]
    insert(frames[1])
    for lv, sv in zip(mine, saved):
        for t, s in zip(lv, sv):
            t.copy_(s)
    for lv, sv in zip(ref, saved):
        for t, s in zip(lv, sv):
            t.copy_(s)
    insert(frames[1])
    assert k3.launches == launches + 9


def _lm_problem(rng, dev, k, moving):
    """K rows on the corridor-like scene, anchors on the planes, 3/4 kept,
    and a motion prior with every beta set."""
    pts = _scene(rng, k)[:k]
    alphas = rng.uniform(0, 1, k).astype(np.float32)
    anchors = pts + rng.normal(scale=0.03, size=pts.shape).astype(np.float32)
    normals = rng.normal(size=pts.shape).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    ok = t(rng.uniform(size=k) < 0.75)
    rows = k5.pack_rows(t(pts), t(alphas), t(anchors), t(normals),
                        t(rng.uniform(0.2, 1.0, k).astype(np.float32)), ok)
    qe = [0.99997, 0.001, -0.002, 0.007] if moving else [1.0, 0, 0, 0]
    te = [0.35, 0.04, 0.01] if moving else [0.0, 0, 0]
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    state = k5.init_state(f([1.0, 0, 0, 0]), f([0.02, -0.01, 0.0]),
                          torch.nn.functional.normalize(f(qe), dim=0), f(te))
    prior = f([1.0, 0, 0, -0.001, -0.02, 0, 0, 0.3, 0.0, 0, 0.001, 0.01,
               0.001, 0.0005])
    return rows, prior, ok.sum(dtype=torch.int32), state


@pytest.mark.parametrize("moving", [False, True])
@pytest.mark.parametrize("freeze_begin", [False, True])
def test_lm_step_matches_plain(cuda, moving, freeze_begin):
    rng = np.random.default_rng(7)
    rows, prior, n_res, state = _lm_problem(rng, cuda, 4096, moving)
    out = checks.check_lm_step(rows, prior, n_res, state, np.float32(0.2),
                               np.float32(0.05), freeze_begin, loop_steps=20)
    assert out["loop"]["steps"] == 20


@pytest.mark.parametrize("n_steps", [1, 3, 20])
@pytest.mark.parametrize("moving", [False, True])
@pytest.mark.parametrize("freeze_begin", [False, True])
def test_lm_loop_matches_plain(cuda, moving, freeze_begin, n_steps):
    rng = np.random.default_rng(11)
    rows, prior, n_res, state = _lm_problem(rng, cuda, 2941, moving)
    launches = k5.launches
    out = checks.check_lm_step(rows, prior, n_res, state, np.float32(0.2),
                               np.float32(0.05), freeze_begin,
                               loop_steps=n_steps)
    assert k5.launches == launches + 2          # the step, then the call
    assert out["loop"]["steps_run"] <= n_steps


def test_lm_loop_rows_beyond_shared_memory(cuda):
    """A problem larger than the cluster keeps on chip: its rows are read
    from global memory."""
    rng = np.random.default_rng(12)
    k = k5.rows_on_chip() + 1000
    rows, prior, n_res, state = _lm_problem(rng, cuda, k, True)
    out = checks.check_lm_step(rows, prior, n_res, state, np.float32(0.2),
                               np.float32(0.05), False, loop_steps=20)
    assert out["loop"]["steps_run"] >= 1


@pytest.mark.parametrize("w, dtype, with_sub", [
    (128, torch.float32, False), (90, torch.float32, True),
    (120, torch.float32, True), (3, torch.float32, False),
    (1, torch.int32, False), (128, torch.int32, False)])
def test_row_gather_matches_plain(cuda, w, dtype, with_sub):
    rng = np.random.default_rng(w)
    c, n = 1 << 14, 20000 + 37          # not a multiple of 512 rows
    table = torch.from_numpy(rng.standard_normal((c, w)) * 100).to(
        device=cuda, dtype=dtype)
    slots = rng.integers(0, c, n)
    slots[rng.uniform(size=n) < 0.2] = -1
    slots = torch.from_numpy(slots).to(device=cuda, dtype=torch.int32)
    sub = (torch.from_numpy(rng.standard_normal(w)).to(
        device=cuda, dtype=torch.float32) if with_sub else None)
    checks.check_row_gather(table, slots, sub)
    # a view whose rows start off a 16-byte boundary takes the 4-byte path
    odd = torch.empty(c * w + 1, device=cuda, dtype=dtype)[1:].view(c, w)
    odd.copy_(table)
    checks.check_row_gather(odd, slots, sub)


@pytest.mark.parametrize("cap_log2, shift", [
    (14, (2.3, -0.7, 0.1)), (14, (-5.0, -5.0, -1.5)), (12, (0.7, 0.3, -0.2))])
def test_rebuild_level_matches_plain(cuda, cap_log2, shift):
    """K7 and K6 through rebuild_level: a level with tombstones (a prune),
    shifts off and on the voxel grid, and a 2^12 level loaded near full."""
    rng = np.random.default_rng(cap_log2)
    level = _warm_level(rng, cuda, cap_log2=cap_log2)
    vm.prune_level(level, torch.zeros(3, device=cuda), 12.0)
    level.normals.copy_(torch.from_numpy(
        rng.standard_normal((level.capacity, 3))).to(cuda))
    level.nflags.copy_(torch.from_numpy(
        rng.integers(0, 4, level.capacity)).to(cuda))
    out = checks.check_rebuild_level(
        level, torch.tensor(shift, dtype=torch.float32, device=cuda), 0.8)
    assert 0 < out["rows"] and out["num_points"] > 0
    assert 1 <= out["claim_rounds"] <= k3.MAX_PROBES


@pytest.mark.parametrize("case", ["chain", "merge"])
def test_rebuild_claim_hand_built_matches_plain(cuda, case):
    """K7 (and the whole rebuild) on the 64-slot levels of
    torch_rebase_cases.py: 20 rows on one probe chain (16 rounds run, 16
    rows kept, 4 dropped) and two rows merged into one voxel."""
    if case == "chain":
        level, shift, _chain = chain_level()
    else:
        level, shift = merge_level()
    level = vm.MapLevel(*(t.to(cuda) for t in level))
    out = checks.check_rebuild_level(level, shift.to(cuda), 0.5)
    if case == "chain":
        assert out["rows"] == 16 and out["claim_rounds"] == k3.MAX_PROBES
    else:
        assert out["rows"] == 11 and out["claim_rounds"] >= 1


def _rebase_tables(rng, dev, c, p, offset):
    """The rebase's fields (points, normals, counts, flags), each a view
    starting ``offset`` elements into its buffer."""
    def view(a):
        buf = torch.empty(a.size + offset, dtype=torch.from_numpy(a).dtype,
                          device=dev)
        t = buf[offset:].view(a.shape)
        t.copy_(torch.from_numpy(a))
        return t
    return (view((rng.standard_normal((c, 3 * p)) * 100).astype(np.float32)),
            view(rng.standard_normal((c, 3)).astype(np.float32)),
            view(rng.integers(0, p + 1, (c, 1)).astype(np.int32)),
            view(rng.integers(0, 4, (c, 1)).astype(np.int32)))


@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("n, p", [(1, 30), (4093, 30), (20011, 40)])
def test_row_gather_fields_matches_plain(cuda, n, p, offset):
    """The one-launch gather of the rebase's four fields (W = 3P, 3, 1, 1;
    the shift subtracted per plane) at N not a multiple of a tile, from
    aligned tables and from views off a 16-byte (offset 1) and an 8-byte
    (offset 2) boundary."""
    rng = np.random.default_rng(n + offset)
    c = 1 << 14
    tables = _rebase_tables(rng, cuda, c, p, offset)
    slots = rng.integers(0, c, n)
    slots[rng.uniform(size=n) < 0.9] = -1
    slots[rng.uniform(size=n) < 0.01] = c + 3
    slots = torch.from_numpy(slots.astype(np.int32)).to(cuda)
    shift = torch.tensor([101.5, -7.25, 0.125], device=cuda)
    launches = k6.launches
    checks.check_row_gather_fields(tables, slots, (shift, None, None, None))
    assert k6.launches == launches + 1


def test_rebuild_level_is_one_k7_and_one_k6_operation(cuda, traced_ops):
    """A rebuild_level on the card is two device operations, the K7 and
    the K6 kernels, and no memset or copy (traced in a fresh process); one
    launch of each."""
    rng = np.random.default_rng(3)
    level = _warm_level(rng, cuda, cap_log2=14)
    shift = torch.tensor([2.3, -0.7, 0.1], device=cuda)
    vm.rebuild_level(level, shift, 0.8)              # warm-up
    torch.cuda.synchronize()
    before = (k7.launches, k6.launches)
    vm.rebuild_level(level, shift, 0.8)
    torch.cuda.synchronize()
    assert (k7.launches, k6.launches) == (before[0] + 1, before[1] + 1)
    names = traced_ops(vm.rebuild_level, level, shift, 0.8)
    if not names:
        pytest.skip("the profiler saw no device activity")
    assert len(names) == 2, names
    assert any("rebuild_claim" in x for x in names), names
    assert any("row_gather" in x for x in names), names


def _ct_ba_window(dev, f, k, edge_alpha, pad=37, seed=0):
    """A CT-BA window on ``dev`` shaped like the backend's: the synthetic
    problem with the backend's prior weight, prior poses off the state,
    a2D-like weights with a padded tail of ``pad`` zero rows a frame, and
    ``edge_alpha`` on every edge."""
    rng = np.random.default_rng(seed)
    state, p, _ = ct_ba.build_synthetic_problem(rng, f, k, noise=0.02)
    w = rng.uniform(0.0, 0.5, (f, k)).astype(np.float32)
    w[:, k - pad:] = 0.0

    def moved(x, scale):
        return x + torch.from_numpy(rng.normal(
            scale=scale, size=tuple(x.shape)).astype(np.float32))

    p = p._replace(weights=torch.from_numpy(w),
                   prior_tr_begin=moved(p.prior_tr_begin, 0.01),
                   prior_tr_end=moved(p.prior_tr_end, 0.01),
                   prior_quat_begin=moved(p.prior_quat_begin, 0.003),
                   prior_quat_end=moved(p.prior_quat_end, 0.003),
                   prior_weight=torch.full((f,), 1.5),
                   edge_alpha=torch.full((f,), float(edge_alpha)))
    state = ct_ba.CTBAState(*(x.to(dev) for x in state))
    p = ct_ba.CTBAProblem(*(x.contiguous().to(dev) for x in p))
    return state, p


@pytest.mark.parametrize("edge_alpha", [1.0, 1.3])
@pytest.mark.parametrize("mode, iters", [("gn", 1), ("gn", 2), ("gn", 4),
                                         ("blocks", 1)])
@pytest.mark.parametrize("f, k", [(8, 4096), (3, 300), (1, 17),
                                  (1, 70000)])
def test_ct_ba_block_matches_plain(cuda, mode, iters, edge_alpha, f, k):
    """K8 at the backend gate's window (F = 8, K = 4,096) and off the CTA
    size, with a padded tail, at edge_alpha 1.0 and 1.3 (extrapolation),
    for 1, 2 and 4 inner iterations in one launch; K = 70,000 puts more
    rows on a CTA than its shared memory keeps, which it reads from global
    memory."""
    state, p = _ct_ba_window(cuda, f, k, edge_alpha, pad=min(37, k // 3))
    poses = ct_ba.pack_state(state)
    launches = k8.launches
    checks.check_ct_ba_block(poses, p, 2.0, 1e-3, mode, iters=iters)
    # one launch a call: two of the kernel's, and one of its iterate before
    # the last where there are several
    assert k8.launches == launches + (2 if iters == 1 else 3)


@pytest.mark.parametrize("f, k", [(8, 4096), (3, 300), (6, 4096)])
@pytest.mark.parametrize("iters", [2, 4])
def test_ct_ba_block_iterations_in_one_launch(cuda, f, k, iters):
    """One launch of n inner iterations gives, bit for bit, what n launches
    of one give, each on the previous one's poses."""
    state, p = _ct_ba_window(cuda, f, k, 1.3, pad=min(37, k // 3))
    checks.check_ct_ba_iterations(ct_ba.pack_state(state), p, 2.0, 1e-3,
                                  iters)


@pytest.mark.parametrize("nlerp", [False, True])
def test_ct_ba_block_repeats_bit_for_bit(cuda, nlerp):
    """500 launches of the backend's refine (F = 8, K = 4,096, 4 inner
    iterations) on one window, each bit-identical to the first: a launch
    depends on its inputs alone (no float atomics, the neighbours' iterates
    read behind their flags, the flags left zero). With each frame's end
    rotation set to its begin rotation the poses take the slerp's nlerp
    branch, as on the backend's first full window, and the row pass is
    shorter beside the pose rows built meanwhile."""
    state, p = _ct_ba_window(cuda, 8, 4096, 1.0)
    if nlerp:
        state = state._replace(quat_end=state.quat_begin.clone())
        p = p._replace(prior_quat_end=p.prior_quat_begin.clone())
    poses = ct_ba.pack_state(state)
    first = k8.ct_ba_block(poses, p, 2.0, 1e-3, "gn", 4)
    differ = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(500):
        again = k8.ct_ba_block(poses, p, 2.0, 1e-3, "gn", 4)
        for x, y in zip(again, first):
            differ += (x != y).any()
    assert int(differ) == 0


def test_ct_ba_block_empty_frames(cuda):
    """K = 0 (no point rows): the pose-level rows alone, one CTA a frame.
    Their rotation block has rank 4 of 6 (four quaternion-dot rows), so the
    damped solve amplifies rounding by ~1/damping and the updated poses are
    held to a second launch only; J^T J, J^T r and the cost to the plain
    version."""
    state, p = _ct_ba_window(cuda, 4, 40, 1.0, pad=40)
    p = p._replace(**{n: getattr(p, n)[:, :0].contiguous()
                      for n in ("raw", "alphas", "anchors", "normals",
                                "weights")})
    poses = ct_ba.pack_state(state)
    for mode, iters in (("gn", 1), ("gn", 2), ("blocks", 1)):
        checks.check_ct_ba_block(poses, p, 2.0, 1e-3, mode,
                                 compare_poses=False, iters=iters)


def test_ct_ba_block_beyond_one_wave(cuda):
    """A window of more clusters than the card holds at once: one inner
    iteration (no cluster waits for another) runs in waves and agrees with
    the plain version; several either run (every cluster resident) or
    raise before launching, and never hang."""
    state, p = _ct_ba_window(cuda, 300, 64, 1.0, pad=5)
    poses = ct_ba.pack_state(state)
    checks.check_ct_ba_block(poses, p, 2.0, 1e-3, "gn")
    launches = k8.launches
    with pytest.raises(ValueError, match="resident"):
        k8.ct_ba_block(poses, p, 2.0, 1e-3, "gn", 2)
    assert k8.launches == launches
    # the flags are still zero: a window that fits runs after it
    small, q = _ct_ba_window(cuda, 8, 4096, 1.3)
    checks.check_ct_ba_block(ct_ba.pack_state(small), q, 2.0, 1e-3, "gn",
                             iters=2)


@pytest.mark.parametrize("solver", ["jacobi", "pcg"])
def test_ct_ba_step_on_card_matches_cpu(cuda, solver):
    """Two CT-BA steps (two inner iterations each, as the backend runs
    them) on the card (K8) and on the CPU (the plain version): poses within
    1e-5 m and 1e-4 deg; the jacobi step is one K8 launch a step (its two
    inner iterations in one launch), the pcg step two (one a CG solve)."""
    state, p = _ct_ba_window(cuda, 8, 4096, 1.3)
    step = ct_ba.make_ct_ba_step(num_inner_iters=2, beta=2.0, solver=solver)
    cpu = (ct_ba.CTBAState(*(x.cpu() for x in state)),
           ct_ba.CTBAProblem(*(x.cpu() for x in p)))
    launches = k8.launches
    a, b = state, cpu[0]
    for _ in range(2):
        a, _ = step(a, p)
        b, _ = step(b, cpu[1])
    torch.cuda.synchronize()
    assert k8.launches == launches + (2 if solver == "jacobi" else 4)
    pa = ct_ba.pack_state(a).double().cpu().numpy()
    pb = ct_ba.pack_state(b).double().numpy()
    assert np.abs(pa[:, 4:7] - pb[:, 4:7]).max() <= 1e-5
    assert np.abs(pa[:, 11:14] - pb[:, 11:14]).max() <= 1e-5
    for x, y in zip(pa, pb):
        assert s3n.angular_distance_deg(x[0:4], y[0:4]) <= 1e-4
        assert s3n.angular_distance_deg(x[7:11], y[7:11]) <= 1e-4


def _evict_coords(rng, level, res, m_found, m_absent, repeat):
    """Voxel coords of ``m_found`` occupied voxels of a street level, plus
    ``m_absent`` absent ones and ``repeat`` repeats, shuffled, padded to a
    power of two, with a mask that drops every 13th and the padding."""
    pts = torch.from_numpy(_scene(rng, 20000)).to(level.keys.device)
    coords = torch.unique(torch.trunc(pts / res).to(torch.int32), dim=0)
    coords = coords[torch.randperm(coords.shape[0],
                                   device=coords.device)][:m_found]
    absent = coords[:m_absent] + torch.tensor([0, 0, 1000], dtype=torch.int32,
                                              device=coords.device)
    coords = torch.cat([coords, absent, coords[:repeat]])
    n = coords.shape[0]
    m = 1 << max(n - 1, 0).bit_length() if n else 0
    coords = torch.cat([coords, torch.zeros((m - n, 3), dtype=torch.int32,
                                            device=coords.device)])
    valid = torch.arange(m, device=coords.device) < n
    valid[::13] = False
    return coords.contiguous(), valid


@pytest.mark.parametrize("m_found, m_absent, repeat", [
    (0, 0, 0), (1, 0, 0), (700, 40, 5), (100000, 100, 300)])
def test_evict_voxels_matches_plain(cuda, m_found, m_absent, repeat):
    rng = np.random.default_rng(m_found)
    level = _warm_level(rng, cuda)
    level.nflags.copy_(torch.where(level.count > 0, 3, 0).to(torch.int32))
    coords, valid = _evict_coords(rng, level, 0.8, m_found, m_absent, repeat)
    before = k9.launches
    out = checks.check_evict_voxels(level, coords, valid)
    assert k9.launches == before + 1
    if m_found > 1:
        assert out["removed"] > 0 and out["emptied"] > 0
    # the accumulator is left zero: a second eviction agrees again
    checks.check_evict_voxels(level, coords, valid)


@pytest.mark.parametrize("counts", [(700, 300, 40), (0, 120, 9),
                                    (4000, 0, 0)])
def test_evict_levels_matches_plain(cuda, counts):
    """Three levels (0.8, 0.5 and 1.5 m) in one launch, each with its own
    row count (zero included; the rows past it, which a replay pads with,
    are garbage and must not be read): identical to the plain version, one
    launch, and a second call agrees again (the accumulators left zero)."""
    rng = np.random.default_rng(sum(counts))
    levels, coords = [], []
    for (cap_log2, res), n in zip(((14, 0.8), (15, 0.5), (12, 1.5)), counts):
        lv = _warm_level(rng, cuda, cap_log2=cap_log2, res=res)
        lv.nflags.copy_(torch.where(lv.count > 0, 3, 0).to(torch.int32))
        c, _ = _evict_coords(rng, lv, res, n, n // 10, n // 20)
        # past the count: real voxels, which an eviction that read them
        # would empty
        tail = _evict_coords(rng, lv, res, 64, 0, 0)[0][:64]
        coords.append(torch.cat([c, tail]).contiguous())
        levels.append(lv)
    counts = [c.shape[0] - 64 for c in coords]
    before = k9.launches
    out = checks.check_evict_levels(levels, coords, counts)
    assert k9.launches == before + 1
    assert out["removed"][-1] == sum(out["removed"][:-1])
    checks.check_evict_levels(levels, coords, counts)


@pytest.mark.parametrize("cap_log2, p, res", [(14, 30, 0.8), (16, 50, 0.2),
                                              (12, 40, 1.5)])
def test_level_normals_matches_plain(cuda, cap_log2, p, res):
    rng = np.random.default_rng(cap_log2)
    level = vm.make_level(cap_log2, p, cuda)
    pts = torch.from_numpy(_scene(rng, 30000)).to(cuda)
    vm.insert_points(level, pts, torch.ones(pts.shape[0], dtype=torch.bool,
                                            device=cuda), res, 0.02, 12)
    # a tombstone with points and a flag: kept as it is
    occ = torch.nonzero(level.count >= 5)[:, 0]
    level.keys[occ[0]] = 1
    level.nflags[occ[1]] = 7
    location = torch.tensor([1.0, -2.0, 1.5], device=cuda)
    # every slot (the tombstone and the empty slots copied through), and
    # the export's list of occupied slots
    every = torch.arange(level.capacity, dtype=torch.int32, device=cuda)
    for slots in (every, vm.occupied_slots(level)):
        before = k10.launches
        out = checks.check_level_normals(level, location, slots)
        assert k10.launches == before + 1
        assert out["refit"] > 100
        assert out["left_out"] <= 0.1 * out["refit"]
    new = vm.recompute_level_normals(level, location)
    assert new.nflags is not level.nflags and new.keys is level.keys


def _pose_gaps(a, b):
    """Largest position (m) and rotation (deg) gaps of two CT-BA states."""
    pa = ct_ba.pack_state(a).double().cpu().numpy()
    pb = ct_ba.pack_state(b).double().cpu().numpy()
    d_tr = max(np.abs(pa[:, 4:7] - pb[:, 4:7]).max(),
               np.abs(pa[:, 11:14] - pb[:, 11:14]).max())
    d_rot = max(max(s3n.angular_distance_deg(x[0:4], y[0:4]),
                    s3n.angular_distance_deg(x[7:11], y[7:11]))
                for x, y in zip(pa, pb))
    return d_tr, d_rot


@pytest.mark.parametrize("k, edge_alpha", [(4096, 1.3), (64, 1.0)])
def test_ct_ba_step_beyond_residency_matches_cpu(cuda, k, edge_alpha):
    """A block-Jacobi step (two inner iterations) over one frame more than
    the card holds at once at K rows (``ct_ba_block.max_resident_frames``):
    it runs as two single-iteration launches, where the one-launch kernel
    raises, and agrees with the CPU run of the same inputs (poses within
    1e-5 m and 1e-4 deg, the cost within rtol 1e-5); the first launch
    held by the K8 check, the second's J^T J within the check's 1e-4 of
    its largest entry from the plain version on the first iterate."""
    f = k8.max_resident_frames(k, cuda) + 1
    assert not k8.resident(f, k, cuda) and k8.resident(f - 1, k, cuda)
    assert ct_ba.jacobi_launches(f, k, 2, cuda) == 2
    state, p = _ct_ba_window(cuda, f, k, edge_alpha, pad=min(37, k // 3))
    with pytest.raises(ValueError, match="resident"):
        k8.ct_ba_block(ct_ba.pack_state(state), p, 2.0, 1e-3, "gn", 2)
    step = ct_ba.make_ct_ba_step(num_inner_iters=2, beta=2.0)
    launches = k8.launches
    a, cost_a = step(state, p)
    torch.cuda.synchronize()
    assert k8.launches == launches + 2
    b, cost_b = step(ct_ba.CTBAState(*(x.cpu() for x in state)),
                     ct_ba.CTBAProblem(*(x.cpu() for x in p)))
    d_tr, d_rot = _pose_gaps(a, b)
    assert d_tr <= 1e-5 and d_rot <= 1e-4, (d_tr, d_rot)
    np.testing.assert_allclose(float(cost_a), float(cost_b), rtol=1e-5)
    poses = ct_ba.pack_state(state)
    checks.check_ct_ba_block(poses, p, 2.0, 1e-3, "gn")
    first = k8.ct_ba_block(poses, p, 2.0, 1e-3, "gn").poses
    second = k8.ct_ba_block(first, p, 2.0, 1e-3, "gn")
    want = k8.ct_ba_block_plain(first, p, 2.0, 1e-3, "gn")
    assert checks._rel_err(second.jtj, want.jtj) <= 1e-4


def test_backend_step_beyond_residency_matches_cpu(cuda):
    """The backend's CT-BA step (its 2 steps of 2 inner iterations folded
    into one of 4) with a window one frame beyond what the card holds at
    the backend's K = 4,096 keypoints: four chained launches, poses and
    cost as the CPU run of the same inputs."""
    from ct_icp_torch.odometry.odometry import Odometry
    from ct_icp_torch.tools import bench as gates
    k = 4096
    f = k8.max_resident_frames(k, cuda) + 1
    o = gates.backend_profile(True)
    o = dataclasses.replace(o, backend=dataclasses.replace(o.backend,
                                                           window=f))
    backend = Odometry(o, device=cuda).backend
    assert backend.window == f
    state, p = _ct_ba_window(cuda, f, k, 1.3)
    launches = k8.launches
    a, cost_a = backend.step(state, p)
    torch.cuda.synchronize()
    assert k8.launches == launches + 2 * o.backend.num_steps
    b, cost_b = backend.step(ct_ba.CTBAState(*(x.cpu() for x in state)),
                             ct_ba.CTBAProblem(*(x.cpu() for x in p)))
    d_tr, d_rot = _pose_gaps(a, b)
    assert d_tr <= 1e-5 and d_rot <= 1e-4, (d_tr, d_rot)
    np.testing.assert_allclose(float(cost_a), float(cost_b), rtol=1e-5)


def _dense_level(cuda, p, per_voxel, voxels=400, res=0.5, seed=5):
    """A level of P-point rows where each of ``voxels`` voxels receives
    ``per_voxel`` points of a tilted plane (counts up to P)."""
    rng = np.random.default_rng(seed)
    centers = (rng.integers(-40, 40, (voxels, 3)) + 0.5) * res
    u = rng.uniform(-0.45, 0.45, (voxels, per_voxel, 2)) * res
    pts = np.stack([u[..., 0], u[..., 1], 0.2 * u[..., 0] - 0.1 * u[..., 1]
                    + rng.normal(scale=0.002, size=u.shape[:2])], -1)
    pts = (pts + centers[:, None, :]).astype(np.float32)
    level = vm.make_level(14, p, cuda)
    # batches of 10 points a voxel (an insert adds up to one a round)
    for j in range(0, per_voxel, 10):
        t = torch.from_numpy(pts[:, j:j + 10].reshape(-1, 3)).to(cuda)
        vm.insert_points(level, t, torch.ones(t.shape[0], dtype=torch.bool,
                                              device=cuda), res, 1e-4, 12)
    return level


@pytest.mark.parametrize("case", ["all refit", "empty", "ragged",
                                  "fifty points", "all refit, repeated"])
def test_level_normals_lists(cuda, case):
    """K10 on the lists beside the export's: every refit slot of a level
    and nothing else (the dirty-slot refit's shape), an empty list (no
    launch, no error), a list whose length is no multiple of any block's
    slots, P = 50 rows holding more than 32 points (the lanes j and j + 32,
    a warp a queued slot), and the refit slots listed again and again, on
    a grid of more blocks than SMs (8 lanes a queued slot)."""
    location = torch.tensor([1.0, -2.0, 1.5], device=cuda)
    if case == "fifty points":
        level = _dense_level(cuda, 50, 70)
        assert int(level.count.max()) == 50
    else:
        rng = np.random.default_rng(21)
        level = _warm_level(rng, cuda, cap_log2=15, p=40, res=0.5)
    occupied = vm.occupied_slots(level)
    refit = k10.refit_mask(level.keys[occupied.long()],
                           level.count[occupied.long()])
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    slots = {"all refit": occupied[refit],
             "empty": occupied[:0],
             "ragged": occupied[:1000 + 37],
             "fifty points": occupied,
             "all refit, repeated": occupied[refit].repeat(
                 32 * sms // max(int(refit.sum()), 1) + 1)}[case].contiguous()
    before = k10.launches
    if case == "empty":
        normals, flags = vm.refit_normals(level, location, slots)
        torch.cuda.synchronize()
        assert normals.shape == (0, 3) and flags.shape == (0,)
        assert k10.launches == before
        return
    out = checks.check_level_normals(level, location, slots)
    assert k10.launches == before + 1
    assert out["refit"] > 100 and out["left_out"] <= 0.1 * out["refit"]
    if case == "all refit":
        assert out["refit"] == slots.shape[0]
    if case == "fifty points":
        assert int((level.count[slots.long()] > 32).sum()) > 100
        assert k10.lanes(slots.shape[0]) == 32
    if case == "all refit, repeated":
        assert out["refit"] == slots.shape[0]
        assert k10.lanes(slots.shape[0]) == 8


def test_level_normals_is_one_device_operation(cuda, traced_ops):
    """A call is one device operation: the kernel, no memset or copy. The
    first of up to ten traces (with idle margins) that saw the device is
    counted, in a fresh process (``traced_ops``): on some of the card's
    machines a process's traces hold no device activity from about 10 s
    after its first trace on (PERF.md §6), and such a trace counts
    nothing."""
    rng = np.random.default_rng(23)
    level = _warm_level(rng, cuda, cap_log2=15, p=40, res=0.5)
    location = torch.tensor([1.0, -2.0, 1.5], device=cuda)
    slots = vm.occupied_slots(level)
    vm.refit_normals(level, location, slots)          # warm-up
    torch.cuda.synchronize()
    names = traced_ops(vm.refit_normals, level, location, slots)
    if not names:
        pytest.skip("the profiler saw no device activity")
    assert len(names) == 1 and "level_normals" in names[0], names


@pytest.mark.parametrize("n, cap", [(1, 70000), (2, 64), (2, 20000),
                                    (4, 5000), (3, 777), (64, 64)])
@pytest.mark.parametrize("m", [0, 1000, 33333])
def test_owner_pack_matches_plain(cuda, m, n, cap):
    """K11 bit for bit: chunks off the block tile, a capacity that drops
    points (64) and one that drops none, 1 to 64 owners, an empty chunk
    (only the zero fill and dropped = 0), invalid points scattered; one
    launch a call."""
    rng = np.random.default_rng(m + n)
    world = torch.from_numpy(np.concatenate([
        _scene(rng, m // 2), _scene(rng, m - m // 2)])
        .reshape(-1, 3)[:m] - 3.0).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=m) < 0.9).to(cuda)
    before = k11.launches
    out = checks.check_owner_pack(world, valid, 0.8, n, cap)
    # two calls, one launch each
    assert k11.launches == before + 2
    if int(valid.sum()) > 2 * n * cap:      # an owner overflows its cap
        assert out["dropped"] > 0


@pytest.mark.parametrize("n", [1, 64])
def test_owner_pack_limit(cuda, n):
    """A chunk of the most points one launch takes (the card's resident
    blocks, each with its most tiles) packs bit for bit; one point more
    raises a ValueError that names the limit, and nothing is launched."""
    most = k11.resident_blocks() * min(
        k11.MAX_TILES, k11.MAX_CELLS // (n * k11.WARPS)) * k11.THREADS
    rng = np.random.default_rng(n)
    world = torch.from_numpy(rng.uniform(-50, 50, (most + 1, 3))
                             .astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=most + 1) < 0.9).to(cuda)
    before = k11.launches
    checks.check_owner_pack(world[:most], valid[:most], 0.8, n, 20000)
    assert k11.launches == before + 2
    with pytest.raises(ValueError, match=f"at most .*{most} points"):
        k11.owner_pack(world, valid, 0.8, n, 20000)
    assert k11.launches == before + 2


def test_owner_pack_is_one_device_operation(cuda, traced_ops):
    """A call is one device operation: the kernel, no memset or copy
    (traced in a fresh process), at the partitioned insert's world-size-1
    shape (m = 65,536, n = 1, cap = 131,072)."""
    rng = np.random.default_rng(11)
    world = torch.from_numpy(_scene(rng, 32768) - 3.0).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=65536) < 0.9).to(cuda)
    k11.owner_pack(world, valid, 0.8, 1, 131072)    # warm-up
    torch.cuda.synchronize()
    names = traced_ops(k11.owner_pack, world, valid, 0.8, 1, 131072)
    if not names:
        pytest.skip("the profiler saw no device activity")
    assert len(names) == 1 and "owner_pack" in names[0], names


@pytest.mark.parametrize("max_dirty", [1 << 15, 50])
@pytest.mark.parametrize("max_rounds", [4, 12])
def test_insert_rank0_and_refit_match_plain(cuda, max_rounds, max_dirty):
    """K3's rank-0 slots and the with_normals insert's refit of them (K10
    on the dirty list, cut by max_dirty or not) against the plain
    versions, on a warm level and its second frame."""
    rng = np.random.default_rng(5)
    level = _warm_level(rng, cuda, cap_log2=14)
    pts = torch.from_numpy(_scene(rng, 8000)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=pts.shape[0]) < 0.95).to(cuda)
    begin = torch.tensor([1.0, -2.0, 1.5], device=cuda)
    out = checks.check_insert_with_normals(level, pts, valid, 0.8, 0.1,
                                           max_rounds, begin, max_dirty)
    assert out["dirty"] == min(out["dirty"], max_dirty) > 0
    assert out["refit"] > 0


@pytest.mark.parametrize("edge_alpha", [1.0, 1.3])
@pytest.mark.parametrize("ends", [(1.0, 1.0), (0.0, 1.0), (1.0, 0.0)])
@pytest.mark.parametrize("f, k", [(8, 4096), (2, 300), (1, 17)])
def test_ct_ba_block_halo_matches_plain(cuda, f, k, ends, edge_alpha):
    """K8's single-iteration launch with a halo (a rank's slice of a
    sharded window: the middle rank, the first, the last), against the
    plain version with the same halo; its J^T r also against the float64
    plain version."""
    state, p = _ct_ba_window(cuda, f + 2, k, edge_alpha,
                             pad=min(37, k // 3))
    whole = ct_ba.pack_state(state)
    sl = ct_ba.CTBAProblem(*(x[1:f + 1].contiguous() for x in p))
    poses = whole[1:f + 1].contiguous()
    halo = torch.zeros((2, 16), device=cuda)
    halo[0, :14], halo[0, 14], halo[0, 15] = whole[0], edge_alpha, ends[0]
    halo[1, :14], halo[1, 15] = whole[f + 1], ends[1]
    checks.check_ct_ba_halo(poses, sl, halo, 2.0, 1e-3)


def test_ct_ba_halo_equals_window_launch(cuda):
    """Two slices with their halos give, bit for bit, the poses, costs,
    J^T J and J^T r of one launch over the whole window, where the window
    and its slices take the same cluster size (kernels/ct_ba_block.py::
    cluster_size; a frame's sums are split over its cluster's CTAs)."""
    f, k = 4, 4096
    assert k8.cluster_size(f, k, cuda, False) == \
        k8.cluster_size(f // 2, k, cuda, False)
    state, p = _ct_ba_window(cuda, f, k, 1.3)
    whole = ct_ba.pack_state(state)
    one = k8.ct_ba_block(whole, p, 2.0, 1e-3, "gn")
    for lo, hi in ((0, f // 2), (f // 2, f)):
        sl = ct_ba.CTBAProblem(*(x[lo:hi].contiguous() for x in p))
        halo = torch.zeros((2, 16), device=cuda)
        if lo > 0:
            halo[0, :14], halo[0, 14], halo[0, 15] = \
                whole[lo - 1], p.edge_alpha[lo - 1], 1.0
        if hi < f:
            halo[1, :14], halo[1, 15] = whole[hi], 1.0
        part = k8.ct_ba_block(whole[lo:hi].contiguous(), sl, 2.0, 1e-3,
                              "gn", 1, halo)
        torch.cuda.synchronize()
        for name in ("poses", "cost", "jtj", "jtr"):
            assert torch.equal(getattr(part, name),
                               getattr(one, name)[lo:hi]), name


def _flagged_level(rng, dev, cap_log2=14, p=30, res=0.8):
    """A warm level whose occupied voxels carry flags 0, 1 or 2 and random
    unit normals: the normal filter keeps and drops voxels of flag 2."""
    level = _warm_level(rng, dev, cap_log2, p, res)
    c = level.capacity
    level.nflags.copy_(torch.from_numpy(rng.integers(0, 3, c).astype(
        np.int32)).to(dev))
    nrm = rng.normal(size=(c, 3))
    level.normals.copy_(torch.from_numpy(
        (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
            np.float32)).to(dev))
    return level


@pytest.mark.parametrize("nv, max_candidates, res", [(1, 0, 0.8),
                                                     (2, 48, 0.5),
                                                     (3, 48, 0.8)])
def test_candidate_gather_normal_filter_matches_plain(cuda, nv,
                                                      max_candidates, res):
    """K1 with the distance strategy's normal filter, bit for bit, over all
    voxels and with the compaction (the distance strategy at its defaults:
    nv = 3, 343 voxels kept to 48)."""
    rng = np.random.default_rng(31)
    level = _flagged_level(rng, cuda, res=res)
    q = torch.from_numpy(_scene(rng, 600)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=q.shape[0]) < 0.9).to(cuda)
    sensor = torch.tensor([0.5, -1.0, 1.8], device=cuda)
    launches = k1.launches
    checks.check_candidate_gather(level, q, valid, res, nv, 1,
                                  max_candidates, sensor)
    assert k1.launches == launches + 1
    _, filtered = k1.candidate_gather(level.keys, level.count, q, valid, res,
                                      nv, 1, max_candidates, level.normals,
                                      level.nflags, sensor)
    _, unfiltered = k1.candidate_gather(level.keys, level.count, q, valid,
                                        res, nv, 1, max_candidates)
    assert int(filtered.sum()) < int(unfiltered.sum())


@pytest.mark.parametrize("k_nearest", [40, None])
def test_plane_moments_radius_per_query_matches_plain(cuda, k_nearest):
    """K2 with a radius a query (the distance strategy's, 0.1-2.0 m), fresh
    and with a cached shell radius. The scene's surfaces carry 1 cm of
    noise, as a scan's do: on the exact planes of the other tests' walls,
    a 2 m neighbourhood's smallest eigenvalue is float32 rounding, and
    a2D (which takes its square root) is determined only to ~1e-3: from
    bit-identical moments the kernel's eigensolve and the plain one's part
    by up to ~1e-3 there, by ~1e-5 on noisy planes
    (``python -m ct_icp_torch.tools.exp_a2d``; PERF.md §7)."""
    rng = np.random.default_rng(32)
    level = _warm_level(rng, cuda, noise=0.01)
    q = torch.from_numpy(_scene(rng, 700)).to(cuda)
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=cuda)
    radius = torch.from_numpy(rng.uniform(0.1, 2.0, q.shape[0]).astype(
        np.float32)).to(cuda)
    slots, cnt = vm.gather_candidate_planes(level, q, valid, 0.8, 3,
                                            max_candidates=48)
    checks.check_plane_moments(level.points, slots, cnt, q, radius,
                               k_nearest)
    fresh = k2.plane_moments_plain(level.points, slots, cnt, q, radius,
                                   k_nearest)
    checks.check_plane_moments(level.points, slots, cnt, q + 0.01, radius,
                               k_nearest, fresh.r_eff2)


@pytest.mark.parametrize("k", [1, 5, 40, 128])
@pytest.mark.parametrize("nv, radius_kind", [(1, "scalar"), (1, "per query"),
                                             (3, "scalar"),
                                             (3, "per query")])
def test_knn_search_matches_plain(cuda, nv, radius_kind, k):
    """K12 against its plain version bit for bit, at O = 27 (the
    corridor's search) and O = 343 (the distance strategy's nv = 3), with a
    scalar radius and a radius a query, and one launch a call."""
    rng = np.random.default_rng(33)
    level = _warm_level(rng, cuda)
    q = torch.from_numpy(_scene(rng, 900)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=q.shape[0]) < 0.95).to(cuda)
    slots, cnt = vm.gather_candidate_planes(level, q, valid, 0.8, nv)
    radius = (1.0 if radius_kind == "scalar" else torch.from_numpy(
        rng.uniform(0.2, 0.8 * nv + 0.4, q.shape[0]).astype(np.float32)
    ).to(cuda))
    launches = k12.launches
    out = checks.check_knn_search(level.points, slots, cnt, q, radius, k)
    assert k12.launches == launches + 1
    assert out["found"] > 0


def test_knn_search_ties_and_duplicates(cuda):
    """Duplicate points in a voxel and across voxels tie exactly: both
    versions keep the lower candidate index first."""
    rng = np.random.default_rng(34)
    level = _warm_level(rng, cuda)
    p = level.max_points
    full = torch.nonzero(level.count >= 8)[:, 0][:400]
    for c in range(3):
        first = level.points[full, c * p].clone()
        level.points[full, c * p + 1:c * p + 5] = first[:, None]
    half = full.shape[0] // 2
    level.points[full[half:2 * half]] = level.points[full[:half]]
    q = torch.from_numpy(_scene(rng, 600)).to(cuda)
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=cuda)
    slots, cnt = vm.gather_candidate_planes(level, q, valid, 0.8, 2)
    checks.check_knn_search(level.points, slots, cnt, q, 1.2, 40)


def _knn_case(dev, case, m=512, n_off=27, p=30, seed=37):
    """Hand-made K1 outputs over a table of rows: ``one distance`` (every
    point on one spot, so that the index alone orders the neighbours),
    ``few live`` (1 to 3 live points a query, fewer than k), ``none live``
    (every other query with no live candidate), ``O = 343`` (343 full
    voxels of 30 points: 10,290 live candidates a query, all in the
    radius)."""
    rng = np.random.default_rng(seed)
    c = 4 * n_off
    points = rng.uniform(-1.0, 1.0, (c, 3 * p)).astype(np.float32)
    slots = rng.integers(0, c, (m, n_off)).astype(np.int32)
    cnt = rng.integers(0, p + 1, (m, n_off)).astype(np.int32)
    if case == "one distance":
        points[:] = 0.25
    if case == "few live":
        cnt[:] = 0
        cnt[np.arange(m), rng.integers(0, n_off, m)] = rng.integers(1, 4, m)
    if case == "none live":
        cnt[::2] = 0
    if case == "O = 343":
        cnt[:] = p
    queries = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (points, slots, cnt, queries))


@pytest.mark.parametrize("k", [1, 5, 40, 128])
@pytest.mark.parametrize("case, n_off, radius", [
    ("one distance", 27, 2.0), ("few live", 27, 2.0), ("none live", 27, 0.7),
    ("O = 343", 343, 4.0)])
def test_knn_search_adversarial_matches_plain(cuda, case, n_off, radius, k):
    """Bit for bit on candidates all at one distance, with fewer live
    candidates than k, with queries that have none, and at 10,290 live
    candidates a query (O = 343, P = 30, all in the radius)."""
    points, slots, cnt, q = _knn_case(cuda, case, n_off=n_off)
    launches = k12.launches
    out = checks.check_knn_search(points, slots, cnt, q, radius, k)
    assert k12.launches == launches + 1
    if case == "O = 343":
        assert int(cnt[0].sum()) == 10290
        assert out["found"] == q.shape[0] * k
    if case == "few live":
        assert 0 < out["found"] <= 3 * q.shape[0]


def test_knn_search_raises_where_it_cannot_run(cuda):
    rng = np.random.default_rng(35)
    level = _warm_level(rng, cuda)
    q = torch.from_numpy(_scene(rng, 10)).to(cuda)
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=cuda)
    slots, cnt = vm.gather_candidate_planes(level, q, valid, 0.8, 1)
    with pytest.raises(ValueError):
        k12.knn_search(level.points, slots, cnt, q, 1.0, k12.MAX_K + 1)
    with pytest.raises(ValueError):
        k12.knn_search(level.points, slots, cnt, q.double(), 1.0, 5)


def test_knn_search_is_one_device_operation(cuda, traced_ops):
    """A call is one device operation: the kernel, no memset or copy (the
    first of up to ten traces that saw the device, in a fresh process, as
    test_level_normals_is_one_device_operation counts)."""
    rng = np.random.default_rng(36)
    level = _warm_level(rng, cuda)
    q = torch.from_numpy(_scene(rng, 1000)).to(cuda)
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=cuda)
    slots, cnt = vm.gather_candidate_planes(level, q, valid, 0.8, 1)
    k12.knn_search(level.points, slots, cnt, q, 1.0, 40)
    torch.cuda.synchronize()
    names = traced_ops(k12.knn_search, level.points, slots, cnt, q, 1.0, 40)
    if not names:
        pytest.skip("the profiler saw no device activity")
    assert len(names) == 1 and "knn_search" in names[0], names


def _lidar(rng, n, valid_frac):
    """A LiDAR-like cloud (directions on the sphere at ranges from 0.2 m to
    60 m, a third of it repeated with a small jitter: crowded voxels) and
    its validity."""
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = np.exp(rng.uniform(np.log(0.2), np.log(60.0), n))
    pts = (u * r[:, None]).astype(np.float32)
    m = n // 3
    pts[:m] = pts[rng.integers(0, n, m)] + rng.normal(
        0, 0.01, (m, 3)).astype(np.float32)
    return pts, rng.uniform(size=n) < valid_frac


_BANDS = ((0.5, 0.1), (2.0, 0.2), (4.0, 0.4), (8.0, 0.8), (16.0, 1.6),
          (200.0, -1.0))


@pytest.mark.parametrize("n, capacity, kw", [
    (65536, 4096, dict(bands=_BANDS)),                   # ADAPTIVE default
    (65536, 4096, dict(bands=_BANDS, k=2, max_keep=3000)),
    (131072, 65536, dict(voxel_size=0.5)),               # the exact sampler
    (65536, 65536, dict(voxel_size=0.3, k=5)),
    (1001, 256, dict(bands=_BANDS, k=3)),
    (0, 16, dict(voxel_size=0.5)), (5000, 0, dict(voxel_size=0.5)),
    (4096, 4096, dict(bands=((1.0, 0.5),)))])            # nothing in range
def test_exact_sample_matches_plain(cuda, n, capacity, kw):
    """Bit for bit, and one launch a call."""
    rng = np.random.default_rng(n + capacity)
    pts, valid = _lidar(rng, n, 0.3)
    pts, valid = (torch.from_numpy(pts).to(cuda),
                  torch.from_numpy(valid).to(cuda))
    launches = k13.launches
    out = checks.check_exact_sample(pts, valid, capacity, **kw)
    assert k13.launches == launches + 1
    if n > 1001 and capacity > 0 and "bands" in kw and len(kw["bands"]) > 1:
        assert out["count"] > 0


def test_exact_sample_across_stamp_wrap(cuda):
    """Calls on either side of the stamp's wrap, bit for bit: the last
    stamps leave words that beat every word after the wrap, so the call
    after the limit clears the table and starts again from stamp 1."""
    rng = np.random.default_rng(5)
    limit = build.launcher("exact_sample", "k13_stamp_limit", ())()
    pts, valid = _lidar(rng, 3000, 0.9)
    pts, valid = (torch.from_numpy(pts).to(cuda),
                  torch.from_numpy(valid).to(cuda))
    dev = pts.device
    state = k13._device_state(dev, k13.table_log2_for(3000),
                              k13._constants()[2])
    state[3][0] = limit - 2
    for after in (limit - 1, limit, 1, 2):
        out = checks.check_exact_sample(pts, valid, 1024, bands=_BANDS, k=2)
        assert out["count"] > 0
        assert int(state[3][0]) == after


def _voxel_case(rng, case):
    """Points and validity: ``one voxel`` (65,536 points in one 0.5 m
    voxel), ``own voxel`` (50,000 points, each the centre of its own voxel,
    in a shuffled order), ``full table`` (65,536 distinct voxels, all
    valid: N / T = 1/4 at T = 2^ceil(log2 4N), the fullest a call's table
    gets)."""
    if case == "one voxel":
        pts = rng.uniform(0.01, 0.49, (65536, 3))
    else:
        n = 50000 if case == "own voxel" else 65536
        coords = np.unique(rng.integers(0, 400, (2 * n, 3)), axis=0)
        coords = coords[rng.permutation(coords.shape[0])[:n]]
        pts = (coords + 0.5) * 0.5
    return (torch.from_numpy(pts.astype(np.float32)),
            torch.ones(pts.shape[0], dtype=torch.bool))


@pytest.mark.parametrize("k", [1, 2, 64])
@pytest.mark.parametrize("case", ["one voxel", "own voxel", "full table"])
def test_exact_sample_adversarial_matches_plain(cuda, case, k):
    """Bit for bit where every point shares one voxel (one slot, every
    claimant of the insert pass waiting on one owner), where every point
    has its own, and at the fullest table."""
    rng = np.random.default_rng(41)
    pts, valid = (t.to(cuda) for t in _voxel_case(rng, case))
    n = pts.shape[0]
    out = checks.check_exact_sample(pts, valid, n, voxel_size=0.5, k=k)
    assert out["count"] == (min(k, n) if case == "one voxel" else n)


def test_exact_sample_repeats_bit_for_bit(cuda):
    """1,000 calls on one input give identical outputs, equal to the plain
    version's: arrival order decides which point claims a slot, and
    nothing else."""
    rng = np.random.default_rng(42)
    pts, valid = _lidar(rng, 65536, 0.3)
    pts, valid = (torch.from_numpy(pts).to(cuda),
                  torch.from_numpy(valid).to(cuda))
    checks.check_exact_sample(pts, valid, 4096, bands=_BANDS)
    first = [t.clone() for t in k13.exact_sample(pts, valid, 4096,
                                                 bands=_BANDS)]
    differ = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(1000):
        out = k13.exact_sample(pts, valid, 4096, bands=_BANDS)
        for a, b in zip(out, first):
            differ += (a != b).sum()
    assert int(differ) == 0
    assert int(first[2]) > 0


def test_exact_sample_is_one_device_operation(cuda, traced_ops):
    """A call is one device operation: the kernel, no memset or copy
    (traced in a fresh process)."""
    rng = np.random.default_rng(9)
    pts, valid = _lidar(rng, 65536, 0.3)
    pts, valid = (torch.from_numpy(pts).to(cuda),
                  torch.from_numpy(valid).to(cuda))
    k13.exact_sample(pts, valid, 4096, bands=_BANDS)      # warm-up
    torch.cuda.synchronize()
    # exact_sample(points, valid, capacity, voxel_size, bands)
    names = traced_ops(k13.exact_sample, pts, valid, 4096, None, _BANDS)
    if not names:
        pytest.skip("the profiler saw no device activity")
    assert len(names) == 1 and "exact_sample" in names[0], names


def test_staged_register_frame_launches_k13_and_k4(cuda, monkeypatch):
    """register_frame of an ADAPTIVE profile on the card: K4 once a frame
    on the raw scan, K13 once a frame after frame 0, no plain version."""
    from ct_icp_torch.config.options import (ResolutionParam,
                                             SamplingOption,
                                             default_driving_profile)
    from ct_icp_torch.datasets import synthetic as syn
    from ct_icp_torch.odometry.odometry import Odometry

    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on the card path")

    monkeypatch.setattr(k13, "exact_sample_plain", refuse)
    monkeypatch.setattr(k4, "grid_sample_plain", refuse)
    d = default_driving_profile()
    opts = dataclasses.replace(
        d, sampling=SamplingOption.ADAPTIVE,
        map_options=dataclasses.replace(
            d.map_options, resolutions=(ResolutionParam(0.8, 0.1, 30, 14),)),
        max_scan_points=32768, max_subsampled_points=32768,
        max_keypoints=1024, max_dirty_voxels=4096,
        ct_icp_options=dataclasses.replace(d.ct_icp_options,
                                           min_number_neighbors=10))
    prims = syn.box_room(half_extent=7.9, height=4.0)
    traj = syn.circular_trajectory(radius=6.0, height=1.5, num_poses=100,
                                   total_time=0.8, angle_span=np.pi / 12)
    acq = syn.SyntheticSensorAcquisition(
        syn.Scene(prims), traj,
        syn.SyntheticAcquisitionOptions(num_points_per_frame=6000,
                                        frame_duration=0.1, max_range=30.0),
        seed=3)
    odo = Odometry(opts)
    assert odo.device.type == "cuda" and not odo._fused_available
    k4_before, k13_before = k4.launches, k13.launches
    summaries = [odo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
                 for i, f in enumerate(acq.frame(i) for i in range(4))]
    assert k4.launches - k4_before == 4
    assert k13.launches - k13_before == 3
    assert all(s.success for s in summaries)
    assert all(s.sample_size > 0 for s in summaries[1:])

