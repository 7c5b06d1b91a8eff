"""One registration through ``CTICPRegistration`` for each search the port
added, against ct_icp_tpu on the room of ``tests/test_solver.py`` (CPU; the
port through its plain kernel versions):

* ``ball_neighborhood=False``: the exact k-NN search (K1 over all voxels,
  K12), the k-NN descriptor;
* the same with ``num_closest_neighbors=2``: two residual rows a keypoint;
* the distance strategy (``tests/test_solver.py:240``'s radii, 0.3-1.5 m):
  a radius a keypoint and the normal filter, on the ball neighbourhood and
  on the exact k-NN.

The room's map is the reference's insert with normals kept (oriented
toward its centre); the floor's normals are then turned over, so the
normal filter drops the floor. Both packages start from the same state
and must agree on the ICP iterations, the residuals of the last one and
the validity, with the poses within 1e-4 m and 1e-3 deg (float32 sums in
another order: the descriptor's and the LM step's). The convergence
thresholds are 0.01 deg and 1 mm: at tests/test_solver.py's 1e-5 deg the
test sits at float32 noise, and rounding alone decides the iteration
count (the distance strategy on the k-NN stops after 5 iterations in one
package and 6 in the other).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.convert import map_state_from_numpy, options_from_dict
from ct_icp_torch.config import options as topt
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.icp.registration import \
    CTICPRegistration as TRegistration
from ct_icp_tpu.config import options as jopt
from ct_icp_tpu.icp import solver as jslv
from ct_icp_tpu.icp.registration import CTICPRegistration as JRegistration
from ct_icp_tpu.mapping import voxel_map as jvm

MAP = jopt.MultiResolutionVoxelMapOptions(
    resolutions=(jopt.ResolutionParam(0.5, 0.05, 40, 16),),
    default_radius=0.8)
HALF = 5.0


def _room_points(rng, n):
    """Random points on the six faces of the cube [-HALF, HALF]^3
    (tests/test_solver.py::room_surface_points, vectorised)."""
    face = rng.integers(0, 6, n)
    uv = rng.uniform(-HALF, HALF, (n, 2))
    axis = face % 3
    pts = np.zeros((n, 3))
    pts[np.arange(n), axis] = np.where(face < 3, HALF, -HALF)
    rest = np.stack([(axis + 1) % 3, (axis + 2) % 3], 1)
    pts[np.arange(n)[:, None], rest] = uv
    return pts


def _room_level():
    rng = np.random.default_rng(5)
    r = MAP.resolutions[0]
    pts = _room_points(rng, 60000).astype(np.float32)
    level, n = jax.jit(jvm.insert_points, static_argnames=(
        "max_dirty", "with_normals", "max_rounds"))(
        jvm.make_level(r.capacity_log2, r.max_num_points), jnp.asarray(pts),
        jnp.ones(pts.shape[0], bool), r.resolution,
        r.min_distance_between_points, jnp.zeros(3, jnp.float32),
        max_dirty=1 << 14, with_normals=True, max_rounds=64)
    f = {k: np.array(v) for k, v in level._asdict().items()}
    p = r.max_num_points
    # the floor's voxels (first point at z = -HALF): normals turned away
    floor = (f["nflags"] == 2) & (f["points"][:, 2 * p] < -HALF + 0.01)
    f["normals"][floor] *= -1.0
    assert int(n) > 10000 and floor.sum() > 50
    return f


def _scan(rng, n):
    """An elastic scan of the room from (begin, end) = (identity, 2 deg
    about z and (0.3, 0.1, 0)): raw points and alphas."""
    world = _room_points(rng, n)
    alphas = rng.uniform(0.0, 1.0, n)
    q_end = s3n.quat_from_rotvec(np.array([0.0, 0.0, np.deg2rad(2.0)]))
    q, t = s3n.se3_interpolate(
        np.broadcast_to(np.array([1.0, 0, 0, 0]), (n, 4)),
        np.zeros((n, 3)), np.broadcast_to(q_end, (n, 4)),
        np.broadcast_to(np.array([0.3, 0.1, 0.0]), (n, 3)), alphas)
    qi, ti = s3n.se3_inverse(q, t)
    return s3n.quat_rotate(qi, world) + ti, alphas


CASES = {
    "knn": dict(icp=dict(ball_neighborhood=False)),
    "knn_kc2": dict(icp=dict(ball_neighborhood=False,
                             num_closest_neighbors=2)),
    "distance": dict(strategy=True),
    "distance_knn": dict(icp=dict(ball_neighborhood=False), strategy=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_registration_matches_reference(case):
    spec = CASES[case]
    jopts = jopt.CTICPOptions(
        num_iters_icp=15, ls_max_num_iters=5, min_number_neighbors=8,
        threshold_orientation_norm=0.01, threshold_translation_norm=1e-3,
        **spec.get("icp", {}))
    strategy = (jopt.DistanceBasedStrategyOptions(radius_min=0.3,
                                                  radius_max=1.5)
                if spec.get("strategy") else None)
    k = 1024
    jreg = JRegistration(jopts, MAP, num_keypoints=k,
                         distance_strategy=strategy)
    treg = TRegistration(
        options_from_dict(dataclasses.asdict(jopts), topt.CTICPOptions),
        options_from_dict(dataclasses.asdict(MAP),
                          topt.MultiResolutionVoxelMapOptions),
        num_keypoints=k,
        distance_strategy=None if strategy is None else options_from_dict(
            dataclasses.asdict(strategy), topt.DistanceBasedStrategyOptions))
    # the same statics (the port has no ROBUST or unroll fields) and the
    # same packed dynamics
    jst = dataclasses.asdict(jreg.statics)
    for name, v in dataclasses.asdict(treg.statics).items():
        assert getattr(v, "value", v) == getattr(jst[name], "value",
                                                 jst[name]), name
    np.testing.assert_array_equal(treg.dynamics(), jreg.dynamics())

    f = _room_level()
    jlevel = jvm.MapLevel(**{n: jnp.asarray(v) for n, v in f.items()})
    tlevel = map_state_from_numpy([f])[0]
    rng = np.random.default_rng(9)
    raw, alphas = _scan(rng, 800)
    raw_k = np.zeros((k, 3), np.float32)
    raw_k[:800] = raw
    alphas_k = np.ones(k, np.float32)
    alphas_k[:800] = alphas
    valid = np.arange(k) < 800
    qb = s3n.quat_from_rotvec(np.array([0, 0, np.deg2rad(0.5)]))
    qe = s3n.quat_from_rotvec(np.array([0, 0, np.deg2rad(1.0)]))
    pose = [np.asarray(x, np.float32) for x in (
        qb, [0.05, -0.05, 0.02], qe, [0.2, 0.2, -0.03])]
    prior = np.zeros(14, np.float32)
    prior[0] = 1.0
    args = [raw_k, alphas_k, valid] + pose + [prior]
    want = jslv.jitted_register_fn(jreg.statics)(
        jlevel, *(jnp.asarray(a) for a in args), jreg.dynamics())
    got = treg.register_fn(tlevel, *(torch.from_numpy(a) for a in args),
                           treg.dynamics())

    assert got.num_iters == int(want.num_iters) > 1
    assert got.valid_problem == bool(want.valid_problem) is True
    assert int(got.num_residuals) == int(want.num_residuals) > 300
    for gq, gt, wq, wt in ((got.quat_begin, got.tr_begin, want.quat_begin,
                            want.tr_begin),
                           (got.quat_end, got.tr_end, want.quat_end,
                            want.tr_end)):
        assert np.linalg.norm(gt.numpy() - np.asarray(wt)) < 1e-4
        assert s3n.angular_distance_deg(
            gq.numpy().astype(np.float64),
            np.asarray(wq).astype(np.float64)) < 1e-3
    # the solve moved the end pose toward the scan's (0.3, 0.1, 0)
    assert np.linalg.norm(got.tr_end.numpy() - [0.3, 0.1, 0.0]) < 0.03


@pytest.mark.parametrize("what", ["adaptive", "none", "random_cap", "gn",
                                  "robust", "point_to_point",
                                  "analytic_jacobian", "kc2_on_the_ball"])
def test_what_stays_unported_raises(what):
    """The keypoint samplers of the reference's staged path (ADAPTIVE,
    NONE, the random cap) and the solvers, distances and Jacobian this
    port does not carry still refuse with NotImplementedError; two
    residuals a keypoint on the ball neighbourhood, which has no sorted
    list, is refused as in the reference (ValueError)."""
    from ct_icp_torch.icp import solver as tslv
    from ct_icp_torch.odometry.odometry import Odometry
    d = topt.default_driving_profile()
    if what in ("adaptive", "none", "random_cap"):
        opts = (dataclasses.replace(d, max_num_keypoints=500)
                if what == "random_cap" else dataclasses.replace(
                    d, sampling=topt.SamplingOption(what.upper())))
        with pytest.raises(NotImplementedError):
            Odometry(opts, device="cpu")
        return
    kw = {"gn": dict(solver=topt.Solver.GN),
          "robust": dict(solver=topt.Solver.ROBUST),
          "point_to_point": dict(distance=topt.IcpDistance.POINT_TO_POINT),
          "analytic_jacobian": dict(analytic_jacobian=True),
          "kc2_on_the_ball": dict(num_closest_neighbors=2)}[what]
    statics = tslv.SolverStatics(num_keypoints=64, max_neighbors=20,
                                 level_index=0, voxel_neighborhood=1, **kw)
    with pytest.raises(ValueError if what == "kc2_on_the_ball"
                       else NotImplementedError):
        tslv.build_register_fn(statics)
