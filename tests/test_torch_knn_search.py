"""Parity of ct_icp_torch's exact k-NN search (K12's plain version, through
K1 over all voxels) with ct_icp_tpu's ``radius_search`` on the same map
(CPU), and of the k-NN descriptor ``compute_description`` and the compat
``ball_search``.

The map holds a ground plane, a wall and a pole at 0.8 m voxels, inserted
by the reference with its normals kept; some voxel normals are turned away
from the sensor so that the normal filter drops voxels. Tie rule: d2 is
the same three products and two sums on both sides (dx*dx + dy*dy + dz*dz,
left to right), so equal inputs give equal d2 and both orders put equal
d2 at the lower candidate index; an FMA contraction in either compiler
could still move a d2 by 1 ulp, so the neighbour at a sorted position is
compared where its d2 is more than 2 ulp from the d2 before and after it
(which is every position on these maps but exact ties, which are held by
the tie-break). Masks are identical; distances within 2 ulp (torch's
sqrt is correctly rounded, XLA's on the CPU is not: 1 ulp off on about
one entry in ten here, 2 ulp on one in ten thousand).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.convert import map_state_from_numpy
from ct_icp_torch.kernels import knn_search as k12
from ct_icp_torch.mapping import voxel_map as tvm
from ct_icp_torch.ops.neighborhood import compute_description as t_desc
from ct_icp_tpu.mapping import voxel_map as jvm
from ct_icp_tpu.ops.neighborhood import compute_description as j_desc

RES = 0.8
SENSOR = np.array([1.0, -2.0, 1.5], np.float32)

_jit_insert = jax.jit(jvm.insert_points,
                      static_argnames=("max_dirty", "with_normals",
                                       "max_rounds"))


@functools.lru_cache(maxsize=None)
def _map(seed=11, p=30):
    """A reference level (as numpy fields, normals and flags kept by its
    insert; every third refit normal flipped away from the sensor) and
    queries near the surfaces."""
    rng = np.random.default_rng(seed)
    jl = jvm.make_level(12, p)
    ground = np.stack([rng.uniform(-6, 6, 9000), rng.uniform(-6, 6, 9000),
                       rng.normal(scale=0.02, size=9000)], -1)
    wall = np.stack([rng.uniform(-6, 6, 4000), np.full(4000, 2.5),
                     rng.uniform(0, 3, 4000)], -1)
    pole = np.stack([rng.normal(scale=0.05, size=800) - 1.0,
                     rng.normal(scale=0.05, size=800) + 1.0,
                     rng.uniform(0, 3, 800)], -1)
    pts = np.concatenate([ground, wall, pole]).astype(np.float32)
    jl, _ = _jit_insert(jl, jnp.asarray(pts), jnp.ones(pts.shape[0], bool),
                        RES, 0.05, jnp.asarray(SENSOR),
                        max_dirty=pts.shape[0], with_normals=True,
                        max_rounds=16)
    f = {k: np.array(v) for k, v in jl._asdict().items()}
    flagged = np.nonzero(f["nflags"] == 2)[0]
    f["normals"][flagged[::3]] *= -1.0
    q = pts[rng.choice(pts.shape[0], 400, replace=False)]
    q = (q + rng.normal(scale=0.08, size=q.shape)).astype(np.float32)
    q[:3] = [[50.0, 0.0, 0.0], [0.0, 0.0, 0.0], [-1.0, 1.0, 1.5]]
    qv = np.ones(q.shape[0], bool)
    qv[::9] = False
    return f, q, qv


def _levels(f):
    jl = jvm.MapLevel(**{k: jnp.asarray(v) for k, v in f.items()})
    return jl, map_state_from_numpy([f])[0]


def _radius(kind, q):
    if kind == "scalar":
        return np.float32(0.9)
    # the distance strategy's law: 0.3 m near the sensor, up to 1.5 m
    d = np.linalg.norm(q - SENSOR, axis=-1)
    return (0.3 + 1.2 * np.minimum(d, 8.0) / 8.0).astype(np.float32)


def _as_torch(r):
    return torch.from_numpy(r) if isinstance(r, np.ndarray) else float(r)


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


def _ulps_apart(a, b):
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32).astype(np.int64))


def _assert_neighbors_match(want, got, min_share=0.95):
    wp, wm, wd = (np.asarray(x) for x in want)
    gp, gm, gd = (x.numpy() for x in got)
    np.testing.assert_array_equal(gm, wm)
    # sqrt on each side: within 2 ulp
    assert _ulps_apart(gd[wm], wd[wm]).max() <= 2
    d2 = np.where(wm, wd.astype(np.float64) ** 2, np.inf)
    with np.errstate(invalid="ignore"):     # inf - inf past the lists
        gap_prev = np.concatenate([np.full((d2.shape[0], 1), np.inf),
                                   np.diff(d2, axis=1)], axis=1)
        gap_next = np.concatenate([np.diff(d2, axis=1),
                                   np.full((d2.shape[0], 1), np.inf)],
                                  axis=1)
    tol = 2 * _ulp(np.where(wm, d2, 1.0))
    clear = wm & (gap_prev > tol) & (gap_next > tol)
    np.testing.assert_array_equal(gp[clear], wp[clear])
    assert clear.sum() >= min_share * wm.sum()
    # the masked-out entries: zeros and inf (the port's convention)
    assert (gp[~gm] == 0).all() and np.isinf(gd[~gm]).all()


@functools.partial(jax.jit, static_argnames=("k", "nv", "filt"))
def _jax_radius_search(jl, q, qv, radius, k, nv, filt):
    return jvm.radius_search(jl, q, qv, radius, RES, nv=nv, k=k,
                             sensor_location=jnp.asarray(SENSOR),
                             use_normal_filter=filt)


@pytest.mark.parametrize("filt", [False, True])
@pytest.mark.parametrize("radius_kind", ["scalar", "per_query"])
@pytest.mark.parametrize("k", [5, 40])
def test_knn_search_matches_radius_search(k, radius_kind, filt):
    f, q, qv = _map()
    jl, tl = _levels(f)
    radius = _radius(radius_kind, q)
    nv = 2 if radius_kind == "per_query" else 1
    want = _jax_radius_search(jl, jnp.asarray(q), jnp.asarray(qv),
                              jnp.asarray(radius), k, nv, filt)
    got = tvm.radius_search(tl, torch.from_numpy(q), torch.from_numpy(qv),
                            _as_torch(radius), RES, nv, k,
                            sensor_location=torch.from_numpy(SENSOR),
                            use_normal_filter=filt)
    _assert_neighbors_match(want, got)
    wm = np.asarray(want[1])
    # the search found full and partial lists, and none for the invalid
    # and the far queries
    assert (wm.sum(1) == k).mean() > 0.3 and (wm.sum(1) < k).any()
    assert not wm[~qv].any() and not wm[0].any()
    if filt:
        plain = _jax_radius_search(jl, jnp.asarray(q), jnp.asarray(qv),
                                   jnp.asarray(radius), k, nv, False)
        assert np.asarray(plain[1]).sum() > wm.sum(), "the filter dropped none"


def test_knn_search_ties_go_to_the_lower_index():
    """Duplicate points (copies of a voxel's first point into its other
    slots, and of one voxel's points into a neighbour voxel's row): every
    duplicate ties, and both searches keep the lower flat index first."""
    f, q, qv = _map()
    f = {k: v.copy() for k, v in f.items()}
    p = f["points"].shape[1] // 3
    full = np.nonzero(f["count"] >= 8)[0][:200]
    for s in full:
        for c in range(3):
            f["points"][s, c * p + 1:c * p + 5] = f["points"][s, c * p]
    # a whole row copied into the next full slot's row
    f["points"][full[1::2]] = f["points"][full[0::2][:len(full[1::2])]]
    jl, tl = _levels(f)
    k = 40
    want = _jax_radius_search(jl, jnp.asarray(q), jnp.asarray(qv),
                              jnp.float32(1.2), k, 2, False)
    got = tvm.radius_search(tl, torch.from_numpy(q), torch.from_numpy(qv),
                            1.2, RES, 2, k)
    wp, wm, wd = (np.asarray(x) for x in want)
    gp, gm, gd = (x.numpy() for x in got)
    np.testing.assert_array_equal(gm, wm)
    assert _ulps_apart(gd[wm], wd[wm]).max() <= 2
    np.testing.assert_array_equal(gp[wm], wp[wm])
    ties = (np.diff(np.where(wm, wd, -1.0), axis=1) == 0) & wm[:, 1:]
    assert ties.sum() > 100, "the case holds no ties"


def test_knn_plain_orders_ties_by_index():
    """On hand-made candidates: equal d2 keep the lower o * P + p first;
    entries past the in-radius ones are zeros, inf and masked out."""
    p = 4
    # candidate 0 (slot 1): (1,0,0) (0,1,0) (.5,0,0) (2,0,0);
    # candidate 1 (slot 2): (0,0,1) (0,.5,0) (3,0,0) (2,0,0)
    pts = {1: [(1, 0, 0), (0, 1, 0), (.5, 0, 0), (2, 0, 0)],
           2: [(0, 0, 1), (0, .5, 0), (3, 0, 0), (2, 0, 0)]}
    points = torch.zeros((3, 3 * p))
    for s, rows in pts.items():
        for j, xyz in enumerate(rows):
            for c in range(3):
                points[s, c * p + j] = xyz[c]
    slots = torch.tensor([[1, 2]], dtype=torch.int32)
    cnt = torch.tensor([[4, 4]], dtype=torch.int32)
    out = k12.knn_search_plain(points, slots, cnt, torch.zeros((1, 3)), 1.5,
                               6)
    # d2 0.25 at flat 2, 5; 1.0 at flat 0, 1, 4; the rest outside
    np.testing.assert_array_equal(out.points[0].numpy(), [
        [.5, 0, 0], [0, .5, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]])
    np.testing.assert_array_equal(out.mask[0].numpy(), [True] * 5 + [False])
    np.testing.assert_array_equal(out.dist[0].numpy(),
                                  [.5, .5, 1, 1, 1, np.inf])


def test_compute_description_matches_reference():
    f, q, qv = _map()
    jl, tl = _levels(f)
    want = _jax_radius_search(jl, jnp.asarray(q), jnp.asarray(qv),
                              jnp.float32(0.9), 20, 1, False)
    got = tvm.radius_search(tl, torch.from_numpy(q), torch.from_numpy(qv),
                            0.9, RES, 1, 20)
    jd = j_desc(want[0], want[1], jnp.asarray(q))
    td = t_desc(got.points, got.mask, torch.from_numpy(q))
    live = np.asarray(want[1]).sum(1) >= 5
    assert live.mean() > 0.5
    # float sums in another order: within 1e-5 of the covariance scale
    cov_w, cov_t = np.asarray(jd.covariance), td.covariance.numpy()
    scale = np.abs(cov_w).max(axis=(1, 2)) + 1e-9
    assert (np.abs(cov_t - cov_w).max(axis=(1, 2))[live]
            / scale[live]).max() < 1e-5
    np.testing.assert_allclose(td.barycenter.numpy()[live],
                               np.asarray(jd.barycenter)[live], atol=1e-6)
    planar = live & (np.asarray(jd.a2D) > 0.5)
    cos = np.abs((td.normal.numpy() * np.asarray(jd.normal)).sum(-1))
    assert planar.sum() > 50 and (1 - cos[planar]).max() < 1e-5
    # a2D takes the square roots of the two smaller eigenvalues: a
    # covariance 1e-5 of its scale apart moves it by up to ~1e-3 where the
    # smallest nears 0 (K2's check holds a2D to 1e-3 for the same reason)
    np.testing.assert_allclose(td.a2D.numpy()[live],
                               np.asarray(jd.a2D)[live], atol=1e-3)


@pytest.mark.parametrize("filt", [False, True])
def test_ball_search_matches_reference(filt):
    f, q, qv = _map()
    jl, tl = _levels(f)
    want = jax.jit(functools.partial(
        jvm.ball_search, resolution=RES, nv=1,
        sensor_location=jnp.asarray(SENSOR), use_normal_filter=filt))(
        jl, jnp.asarray(q), jnp.asarray(qv), jnp.float32(0.9))
    got = tvm.ball_search(tl, torch.from_numpy(q), torch.from_numpy(qv), 0.9,
                          RES, 1, sensor_location=torch.from_numpy(SENSOR),
                          use_normal_filter=filt)
    cand, mask, closest, cdist, count = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[1].numpy(), mask)
    np.testing.assert_array_equal(got[0].numpy()[mask], cand[mask])
    np.testing.assert_array_equal(got[4].numpy(), count)
    np.testing.assert_array_equal(got[2].numpy()[count > 0],
                                  closest[count > 0])
    live = count > 0
    assert _ulps_apart(got[3].numpy()[live], cdist[live]).max() <= 2
    assert (count > 10).mean() > 0.5


# ---- a numpy model of K12's warp select (csrc/knn_search.cu), step for
# step: the same compare-exchange pairs and directions as the kernel, a
# lane a column. A wrong network shows here, against the plain version.
_NONE = np.uint64(0xFFFFFFFFFFFFFFFF)
_LANE = np.arange(32)


def _sort32_desc(b):
    """sort32_desc (csrc/knn_search.cu:95-107): stage ``size`` ascends
    where lane & size is set; at stride s the lower lane of a pair keeps
    the smaller key where its block ascends."""
    size = 2
    while size <= 32:
        up = (_LANE & size) != 0
        s = size >> 1
        while s:
            o = b[_LANE ^ s]
            lower_min = ((_LANE & s) == 0) == up
            b = np.where(lower_min, np.minimum(b, o), np.maximum(b, o))
            s >>= 1
        size <<= 1
    return b


def _bitonic_to_ascending(a):
    """bitonic_to_ascending (:112-136) on a [R, 32] (element r * 32 + l in
    a[r, l]): strides 32 R / 2 .. 32 within a lane, then 16 .. 1 across
    lanes, the lower element keeping the smaller key."""
    a = a.copy()
    r_count = a.shape[0]
    rs = r_count >> 1
    while rs:
        for r in range(r_count):
            if not r & rs:
                lo = np.minimum(a[r], a[r + rs])
                a[r + rs] = np.maximum(a[r], a[r + rs])
                a[r] = lo
        rs >>= 1
    s = 16
    while s:
        o = a[:, _LANE ^ s]
        a = np.where((_LANE & s) == 0, np.minimum(a, o), np.maximum(a, o))
        s >>= 1
    return a


def _merge_batch(a, b_desc):
    """merge_batch (:142-147): the last register against the batch sorted
    descending, then the half-cleaners."""
    a = a.copy()
    a[-1] = np.minimum(a[-1], b_desc)
    return _bitonic_to_ascending(a)


def _registers(k):
    return 1 if k <= 32 else 2 if k <= 64 else 4


def _warp_select_model(points, slots, cnt_ok, queries, radius, k, split):
    """K12's selection on numpy inputs (points f32[C, 3P], slots / cnt_ok
    int32[M, O], queries f32[M, 3], radius a float or f32[M]): per query,
    ``split`` warps each take every split-th batch of 32 live candidates
    (:223), drop the keys outside the radius or not below the k-th kept
    one (:225-235), skip a batch with none left (:236), merge the rest
    (:237-238, the k-th key as kth_key reads it, :154-159); the other
    warps' arrays then meet the first warp's reversed (:242-257). Returns
    the first k keys of each query, uint64 [M, k]."""
    m, n_off = cnt_ok.shape
    p = points.shape[1] // 3
    r_count = _registers(k)
    length = 32 * r_count
    r2 = (np.float32(radius) * np.float32(radius) if np.isscalar(radius)
          else radius * radius)
    r2 = np.broadcast_to(np.asarray(r2, np.float32), (m,))
    out = np.empty((m, k), np.uint64)
    for q in range(m):
        offs = np.concatenate([[0], np.cumsum(cnt_ok[q])])
        total = int(offs[-1])
        arrays = []
        for w in range(split):
            a = np.full((r_count, 32), _NONE)
            kth = _NONE
            for base in range(32 * w, total, 32 * split):
                i = base + _LANE
                keys = np.full(32, _NONE)
                live = i < total
                o = np.searchsorted(offs, i[live], side="right") - 1
                j = i[live] - offs[o]
                rows = points[slots[q, o]]
                dx = rows[np.arange(len(o)), j] - queries[q, 0]
                dy = rows[np.arange(len(o)), p + j] - queries[q, 1]
                dz = rows[np.arange(len(o)), 2 * p + j] - queries[q, 2]
                d2 = (dx * dx + dy * dy) + dz * dz
                key = ((d2.view(np.uint32).astype(np.uint64) << np.uint64(32))
                       | (o * p + j).astype(np.uint64))
                keys[live] = np.where(d2 <= r2[q], key, _NONE)
                keys[keys >= kth] = _NONE
                if (keys == _NONE).all():
                    continue
                a = _merge_batch(a, _sort32_desc(keys))
                e = k - 1
                # kth_key's register: the last, or at R = 4 and k <= 96
                # the one before it
                assert e >> 5 == r_count - 1 - (r_count == 4 and k <= 96)
                kth = a[e >> 5, e & 31]
            arrays.append(a)
        a = arrays[0]
        for h in arrays[1:]:
            a = _bitonic_to_ascending(
                np.minimum(a, h.reshape(-1)[::-1].reshape(r_count, 32)))
        assert a.shape == (r_count, 32) and length >= k
        out[q] = a.reshape(-1)[:k]
    return out


def _model_neighbors(points, slots, keys):
    """The kernel's epilogue (:259-283) on the model's keys; the root is
    torch's, as the plain version takes it here (the kernel's
    __fsqrt_rn is held to torch's on the card)."""
    p = points.shape[1] // 3
    bits = (keys >> np.uint64(32)).astype(np.uint32)
    found = bits < np.uint32(0x7F800000)
    flat = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
    o, j = np.where(found, flat // p, 0), np.where(found, flat % p, 0)
    rows = points[np.take_along_axis(slots, o, 1)]
    pts = np.stack([np.take_along_axis(rows[..., c * p:(c + 1) * p],
                                       j[..., None], 2)[..., 0]
                    for c in range(3)], -1)
    pts = np.where(found[..., None], pts, np.float32(0))
    root = torch.sqrt(torch.from_numpy(bits.view(np.float32))).numpy()
    dist = np.where(found, root, np.float32(np.inf)).astype(np.float32)
    return pts, found, dist


def _select_case(case, seed=21, m=40, n_off=27, p=12):
    """Candidates on which the selection is held to the plain version:
    random points; ties (every point of a voxel on one point, and voxels
    that repeat another's row); every candidate at one distance."""
    rng = np.random.default_rng(seed)
    c = 3 * n_off
    points = rng.uniform(-1.0, 1.0, (c, 3 * p)).astype(np.float32)
    if case == "ties":
        for s in range(0, c, 3):
            for d in range(3):
                points[s, d * p + 1:d * p + p // 2] = points[s, d * p]
        points[1::4] = points[0::4][:len(points[1::4])]
    if case == "one distance":
        points[:] = 0.0
        points[:, :p] = 0.5
    slots = rng.integers(0, c, (m, n_off)).astype(np.int32)
    if case == "duplicates":
        slots[:, 1::2] = slots[:, 0::2][:, :n_off // 2]
    cnt = rng.integers(0, p + 1, (m, n_off)).astype(np.int32)
    cnt[0] = 0                       # a query with no live candidate
    cnt[1] = 0
    cnt[1, 5] = 3                    # fewer live candidates than k
    queries = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    return points, slots, cnt, queries


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("case", ["random", "ties", "duplicates",
                                  "one distance"])
@pytest.mark.parametrize("k", [1, 5, 40, 128])
def test_warp_select_model_matches_plain(k, case, split):
    """K12's compare-exchange schedule (batch sort, merge, the split's
    hand-over) gives the plain version's neighbours bit for bit, on random,
    tied and duplicate candidates and on candidates all at one distance;
    with a scalar radius and a radius a query."""
    points, slots, cnt, queries = _select_case(case)
    rng = np.random.default_rng(k + split)
    for radius in (np.float32(0.9), rng.uniform(
            0.2, 1.5, queries.shape[0]).astype(np.float32)):
        keys = _warp_select_model(points, slots, cnt, queries, radius, k,
                                  split)
        got = _model_neighbors(points, slots, keys)
        r = radius if np.isscalar(radius) else torch.from_numpy(radius)
        want = k12.knn_search_plain(
            torch.from_numpy(points), torch.from_numpy(slots),
            torch.from_numpy(cnt), torch.from_numpy(queries),
            float(r) if np.isscalar(radius) else r, k)
        np.testing.assert_array_equal(got[1], want.mask.numpy())
        np.testing.assert_array_equal(got[0], want.points.numpy())
        np.testing.assert_array_equal(got[2], want.dist.numpy())
        assert not got[1][0].any() and got[1][1].sum() <= 3


def test_warp_select_networks_sort():
    """The two networks alone: sort32_desc sorts any 32 keys descending;
    merge_batch leaves the smallest 32 R of an ascending array and a batch,
    ascending, at R = 1, 2, 4."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        b = rng.integers(0, 1 << 40, 32).astype(np.uint64)
        b[rng.uniform(size=32) < 0.2] = _NONE
        np.testing.assert_array_equal(_sort32_desc(b), np.sort(b)[::-1])
        for r_count in (1, 2, 4):
            a = np.sort(rng.integers(0, 1 << 40, 32 * r_count).astype(
                np.uint64))
            a[rng.uniform(size=a.size) < 0.1] = _NONE
            a = np.sort(a).reshape(r_count, 32)
            got = _merge_batch(a, np.sort(b)[::-1]).reshape(-1)
            np.testing.assert_array_equal(
                got, np.sort(np.concatenate([a.reshape(-1), b]))[:a.size])
