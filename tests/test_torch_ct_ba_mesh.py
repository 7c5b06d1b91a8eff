"""The CT-BA step on a window sharded over gloo ranks
(ct_icp_torch.parallel.ct_ba.make_ct_ba_step(group=...), comm.spawn) against
ct_icp_tpu's make_ct_ba_step on a JAX Mesh of the same size (1, 2 and 4),
on the graft entry's problem: build_synthetic_problem with 2 frames a rank
and 64 points a frame, block-Jacobi over 2 inner iterations and PCG over 1
with 8 CG iterations.

Poses within 1e-5 m and 1e-5 rad of the reference, costs within rtol 1e-4
(test_torch_ct_ba.py's bounds; the ranks' costs and the PCG dot products
are summed in gloo's order, the reference's by XLA's psum). The block-Jacobi
poses at n ranks equal the port's one-device step bit for bit: a frame's
update reads its own rows and its neighbours' poses, and K8's plain
version extrapolates a halo neighbour as it does a neighbour inside the
window. The cost, a sum over the ranks, within rtol 1e-6.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from ct_icp_torch.convert import ct_ba_from_numpy
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.parallel import comm
from ct_icp_torch.parallel import ct_ba as tba
from ct_icp_tpu.parallel import ct_ba as jba

RANKS = (1, 2, 4)
FRAMES_PER_RANK = 2
POINTS = 64
POSE_ATOL_M = 1e-5
POSE_ATOL_RAD = 1e-5
COST_RTOL, COST_ATOL = 1e-4, 1e-9
CONFIGS = [dict(num_inner_iters=2, solver="jacobi"),
           dict(num_inner_iters=1, solver="pcg", num_cg_iters=8)]


def _problem(n):
    js, jp, _ = jba.build_synthetic_problem(np.random.default_rng(0),
                                            FRAMES_PER_RANK * n, POINTS,
                                            noise=0.01)
    as_np = lambda x: {f: np.asarray(v) for f, v in x._asdict().items()}
    return js, jp, as_np(js), as_np(jp)


def _rot_gap_rad(qa, qb):
    qa = s3n.quat_normalize(np.asarray(qa, np.float64))
    qb = s3n.quat_normalize(np.asarray(qb, np.float64))
    d = np.clip(np.abs(np.sum(qa * qb, axis=-1)), 0.0, 1.0)
    return 2.0 * np.arccos(d)


def _gathered(ranks, i):
    """Config i's window state, the ranks' slices in rank order."""
    return {f: np.concatenate([r[i]["state"][f] for r in ranks])
            for f in ranks[0][i]["state"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    out = {}
    for n in RANKS:
        js, jp, ns, npr = _problem(n)
        mesh = Mesh(np.array(jax.devices()[:n]), ("frames",))
        jsh, jph = jba.shard_problem(mesh, js, jp)
        ref = []
        for cfg in CONFIGS:
            new, cost = jba.make_ct_ba_step(mesh, **cfg)(jsh, jph)
            ref.append({"state": {f: np.asarray(v)
                                  for f, v in new._asdict().items()},
                        "cost": float(cost)})
        port = comm.spawn("torch_dist_cases:ct_ba_steps", n, d,
                          args=(ns, npr, CONFIGS))
        out[n] = (port, ref, ns, npr)
    return out


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("i", range(len(CONFIGS)),
                         ids=[c["solver"] for c in CONFIGS])
def test_step_matches_reference(runs, n, i):
    port, ref, _, _ = runs[n]
    got, want = _gathered(port, i), ref[i]["state"]
    for f in ("tr_begin", "tr_end"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=POSE_ATOL_M)
    for f in ("quat_begin", "quat_end"):
        assert _rot_gap_rad(got[f], want[f]).max() < POSE_ATOL_RAD
    for r in port:       # every rank holds the window's cost
        np.testing.assert_allclose(r[i]["cost"], ref[i]["cost"],
                                   rtol=COST_RTOL, atol=COST_ATOL)


@pytest.mark.parametrize("n", RANKS)
def test_jacobi_equals_one_device_step(runs, n):
    port, _, ns, npr = runs[n]
    st, pr = ct_ba_from_numpy(ns, npr)
    new, cost = tba.make_ct_ba_step(**CONFIGS[0])(st, pr)
    got = _gathered(port, 0)
    for f, v in new._asdict().items():
        np.testing.assert_array_equal(got[f], v.numpy(), err_msg=f)
    np.testing.assert_allclose(port[0][0]["cost"], float(cost), rtol=1e-6)


def test_halo_rows_on_one_rank():
    """Without a group the halo wraps onto the slice itself and both end
    edges are absent: the one-device neighbours."""
    _, _, ns, npr = _problem(2)
    st, pr = ct_ba_from_numpy(ns, npr)
    poses = tba.pack_state(st)
    halo = tba.halo_rows(poses, pr.edge_alpha, None)
    np.testing.assert_array_equal(halo[0, :14].numpy(), poses[-1].numpy())
    np.testing.assert_array_equal(halo[1, :14].numpy(), poses[0].numpy())
    assert float(halo[0, 15]) == 0.0 and float(halo[1, 15]) == 0.0
    with_halo = tba.neighbours(*tba.unpack_state(poses), pr.edge_alpha, halo)
    plain = tba.neighbours(*tba.unpack_state(poses), pr.edge_alpha)
    for a, b in zip(with_halo, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
