"""The JAX package's staged per-frame path on chip_smoke.py's staged runs,
on the CPU: the mean APE and the failures that chip_smoke.py's staged
phases hold the port's runs to (within 1.5 times the APE, with 0
failures), for each of:

  adaptive         default_driving_profile() with sampling=ADAPTIVE;
  adaptive_robust  the same with robust_registration=True;
  cap              default_driving_profile() with max_num_keypoints=1000
                   (GRID keypoints, the random cap from frame
                   init_num_frames on);
  none             default_driving_profile() with sampling=NONE;
  adaptive_k2_cap  ADAPTIVE with num_points_per_voxel=2 and
                   max_num_points=3000.

    PYTHONPATH=. python tests/torch_staged_reference.py \\
        [--runs adaptive,cap] [--frames 80]

Every run registers the driving corridor's frames (seed 3,
``ct_icp_torch/datasets/corridor.py``, numpy only) one at a time through
``Odometry.register_frame``: ``--frames`` (default 80) are rendered, as
chip_smoke.py's driving phase renders them, and a run takes all of them or,
given as ``name:n``, the first n (chip_smoke.py runs none and
adaptive_k2_cap for 10 frames). Prints one JSON line a run. Not collected
by pytest.

    PYTHONPATH=. python tests/torch_staged_reference.py --per-frame \\
        [--runs adaptive_robust] [--frames 80] [--port FILE ...]

records the runs frame by frame in both packages on the CPU
(``ct_icp_torch/tools/staged_record.py``: sub-frame and keypoint digests,
each attempt's level and the numbers its assessment compared, the insert
decision, the poses), writes them to ``build/staged_record_jax.json`` and
``build/staged_record_cpu.json``, and prints the first frame at which the
port parts from the reference. Each ``--port`` file (a record the tool
wrote, e.g. on the card) is compared with the reference's and with the
port's CPU record as well.

    PYTHONPATH=. python tests/torch_staged_reference.py --solver-dump F \\
        [--runs adaptive_robust] [--attempt 0]

runs the JAX package's run to frame F, takes the inputs of that frame's
registration attempt (the map, the keypoints, the initial poses, the prior
and the attempt's options) and registers them again in both packages on
the CPU, ICP iteration by ICP iteration: the JAX package through its own
staged loop pieces (``solver.build_staged_fns``, the body its fused loop
runs), the port through ``CTICPRegistration.register_device`` with its
solver's stages observed. Prints, an iteration a line, the neighbourhood
counts, the ``ok`` mask, the weights, and the LM call's cost, residual
count and poses of each, and how far the port's are from the reference's;
and how far the reference's fused program (what its run took) is from its
staged loop on the same inputs: the gap of the reference to itself under
another float32 summation order.
"""

import argparse
import dataclasses
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from ct_icp_torch.datasets import corridor as cor  # noqa: E402
from ct_icp_torch.tools import staged_record as rec  # noqa: E402
from ct_icp_tpu.config import options as jopt  # noqa: E402
from ct_icp_tpu.odometry import odometry as jodo  # noqa: E402
from ct_icp_tpu.odometry.odometry import Odometry  # noqa: E402


def run_options(name: str):
    """The options of chip_smoke.py's staged run ``name``, in the JAX
    package."""
    d = jopt.default_driving_profile()
    adaptive = jopt.SamplingOption.ADAPTIVE
    if name == "adaptive":
        return dataclasses.replace(d, sampling=adaptive)
    if name == "adaptive_robust":
        return dataclasses.replace(d, sampling=adaptive,
                                   robust_registration=True)
    if name == "cap":
        return dataclasses.replace(d, max_num_keypoints=1000)
    if name == "none":
        return dataclasses.replace(d, sampling=jopt.SamplingOption.NONE)
    if name == "adaptive_k2_cap":
        return dataclasses.replace(
            d, sampling=adaptive,
            adaptive_options=jopt.AdaptiveGridSamplingOptions(
                num_points_per_voxel=2, max_num_points=3000))
    raise ValueError(name)


# the frame whose first attempt the nudged reference runs start one ulp off
NUDGE_FRAME = 2


def per_frame(runs, n, ports, nudges=()):
    """Both packages' records of ``runs`` over the first ``n`` corridor
    frames on the CPU, and the first frame where each port record parts
    from the reference's."""
    import torch

    from ct_icp_torch.odometry import odometry as todo
    torch.set_num_threads(4)
    frames = rec.corridor_frames(n)
    jax_recs, cpu_recs = {}, {}
    for name in runs:
        for recs, mod, make in (
                (jax_recs, jodo, lambda: Odometry(run_options(name))),
                (cpu_recs, todo, lambda: todo.Odometry(
                    rec.run_options(name), device="cpu"))):
            t0 = time.time()
            odo = make()
            recs[name] = rec.record(odo, mod, frames)
            errs = cor.seq_ape(odo, frames)
            print(json.dumps({name: dict(
                rec.summary(recs[name]), package=mod.__name__,
                mean_ape_m=float(np.mean(errs)),
                seconds=time.time() - t0)}), flush=True)
    for name in runs:
        for ulps in nudges:
            t0 = time.time()
            odo = Odometry(run_options(name))
            r = rec.record(odo, jodo, frames[:NUDGE_FRAME])
            nudge(odo, ulps)
            r += rec.record(odo, jodo, frames[NUDGE_FRAME:],
                            first=NUDGE_FRAME)
            errs = cor.seq_ape(odo, frames)
            print(json.dumps({name: dict(
                rec.summary(r), package="ct_icp_tpu.odometry.odometry",
                nudge=f"{ulps:+d} ulp at frame {NUDGE_FRAME}",
                mean_ape_m=float(np.mean(errs)),
                first_against_unnudged=rec.first_divergence(
                    jax_recs[name], r),
                seconds=time.time() - t0)}), flush=True)
    os.makedirs("build", exist_ok=True)
    for tag, recs in (("jax", jax_recs), ("cpu", cpu_recs)):
        with open(f"build/staged_record_{tag}.json", "w") as f:
            json.dump(recs, f)
    others = [("port cpu", cpu_recs)]
    for p in ports:
        with open(p) as f:
            others.append((p, json.load(f)))
    for name in runs:
        for tag, recs in others:
            if name not in recs:
                continue
            print(json.dumps({"run": name, "port": tag, "against": "jax",
                              "first": rec.first_divergence(
                                  jax_recs[name], recs[name]),
                              "attempts": rec.threshold_report(
                                  jax_recs[name], recs[name],
                                  run_options(name))}))
            if tag != "port cpu":
                print(json.dumps({"run": name, "port": tag,
                                  "against": "port cpu",
                                  "first": rec.first_divergence(
                                      cpu_recs[name], recs[name])}))


def _level_np(level):
    return {f: np.asarray(getattr(level, f)) for f in level._fields}


def _poses(frame):
    return (np.asarray(frame.begin_pose.quat, np.float64),
            np.asarray(frame.begin_pose.tr, np.float64),
            np.asarray(frame.end_pose.quat, np.float64),
            np.asarray(frame.end_pose.tr, np.float64))


def _gap(a, b):
    """(translation m, rotation deg) between two [qb, tb, qe, te] lists:
    the larger of begin's and end's."""
    def ang(q1, q2):
        d = abs(float(np.dot(q1, q2))) / float(np.linalg.norm(q1)
                                               * np.linalg.norm(q2))
        return float(np.degrees(2 * np.arccos(min(d, 1.0))))
    return (max(float(np.linalg.norm(np.subtract(a[i], b[i])))
                for i in (1, 3)),
            max(ang(np.asarray(a[i]), np.asarray(b[i])) for i in (0, 2)))


def capture_attempt(name, frame, attempt):
    """The JAX package's run ``name`` to ``frame``: the inputs of that
    frame's registration attempt ``attempt`` and the poses its fused
    program returned."""
    frames = rec.corridor_frames(frame + 1)
    odo = Odometry(run_options(name))
    seen = []
    inner = odo.registration.register_device

    def spy(map_state, raw, alphas, valid, fr, prior=None, origin=None,
            options=None):
        take = len(seen) == attempt
        if take:
            # copies: the map's arrays are donated to its next update
            seen.append(dict(levels=[_level_np(lv)
                                     for lv in map_state.levels],
                             level_type=type(map_state.levels[0]),
                             raw=np.asarray(raw), alphas=np.asarray(alphas),
                             valid=np.asarray(valid), init=_poses(fr),
                             prior=np.asarray(prior),
                             origin=np.asarray(origin), options=options))
        else:
            seen.append(None)
        out = inner(map_state, raw, alphas, valid, fr, prior=prior,
                    origin=origin, options=options)
        if take:
            seen[-1]["fused"] = _poses(fr)
            seen[-1]["fused_iters"] = out.num_iters
        return out

    for i, f in enumerate(frames):
        if i == frame:
            odo.registration.register_device = spy
        odo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
    return odo, seen[attempt]


def jax_iterations(odo, cap):
    """The reference's staged loop on the captured inputs, a record an ICP
    iteration (``registration.staged_register_loop``'s loop)."""
    import jax
    import jax.numpy as jnp

    from ct_icp_tpu.core import se3_np as js3n
    from ct_icp_tpu.icp import residuals as jres
    from ct_icp_tpu.icp import solver as jslv
    from ct_icp_tpu.mapping import voxel_map as jvm
    reg = odo.registration
    statics = reg.statics
    stage_init, stage_build, stage_solve = jslv.build_staged_fns(statics)
    dyn_np = reg.dynamics(cap["options"])
    dyn = jnp.asarray(dyn_np)
    prior = jnp.asarray(cap["prior"])
    origin = cap["origin"]
    qb, tb, qe, te = cap["init"]
    qb, qe = js3n.quat_normalize(qb), js3n.quat_normalize(qe)
    qb, tb, qe, te = (jnp.asarray(x, jnp.float32)
                      for x in (qb, tb - origin, qe, te - origin))
    level = cap["level_type"](**{
        k: jnp.asarray(v) for k, v in cap["levels"][reg.level_index].items()})
    raw, alphas, valid = (jnp.asarray(cap[k])
                          for k in ("raw", "alphas", "valid"))
    carry, r_max = stage_init(raw, valid, qb, tb, qe, te)
    sensor = te
    d = jslv.unpack_dynamics(dyn_np)

    @jax.jit
    def counts(carry, planes, dyn):
        d = jslv.unpack_dynamics(dyn)
        world = jres.interp_world_points(carry[1], carry[2], carry[3],
                                         carry[4], raw, alphas)
        return jvm.moments_from_planes(
            planes[0], planes[1], world, d.search_radius,
            k_nearest=(d.max_number_neighbors if statics.knn_moments
                       else None),
            cached_r_eff2=planes[2], use_fresh=False, return_r_eff2=True)[0]

    out = []
    for _ in range(int(d.num_iters_icp)):
        problem, a_tr, a_q = stage_build(carry, level, raw, alphas, valid,
                                         dyn, sensor, r_max)
        cnt = counts(carry, problem[7], dyn)
        start = carry[1:5]
        carry = stage_solve(carry, problem, a_tr, a_q, raw, alphas, dyn,
                            prior)
        out.append(dict(problem=problem, start=start,
                        count=np.asarray(cnt), ok=np.asarray(problem[5]),
                        weight=np.asarray(problem[4]),
                        normal=np.asarray(problem[1]),
                        cost=float(carry[5]), n_res=int(carry[7]),
                        pose=[np.asarray(carry[i], np.float64)
                              for i in (1, 2, 3, 4)]))
        if bool(carry[6]):
            break
    return out


def port_iterations(name, cap):
    """The port's register_device on the captured inputs (the plain
    versions on the CPU), its solver's stages observed: a record an ICP
    iteration."""
    import torch

    from ct_icp_torch import convert
    from ct_icp_torch.config import options as topt
    from ct_icp_torch.core.pose import Pose, TrajectoryFrame
    from ct_icp_torch.icp import solver as tslv
    from ct_icp_torch.odometry import odometry as todo
    odo = todo.Odometry(rec.run_options(name), device="cpu")
    tmap = convert.map_state_from_numpy(cap["levels"])
    qb, tb, qe, te = cap["init"]
    fr = TrajectoryFrame(Pose(qb.copy(), tb.copy()), Pose(qe.copy(),
                                                          te.copy()))
    out, pending = [], {}
    build, lm_loop = tslv._build_problem, tslv._lm_inner_loop
    moments = tslv.vm.moments_from_planes

    def spy_moments(*a, **kw):
        mom = moments(*a, **kw)
        pending["count"] = mom.count.numpy().copy()
        return mom

    def spy_build(*a, **kw):
        r = build(*a, **kw)
        anchors, normals, geom_w, ok, _ = r
        pending.update(ok=ok.numpy().copy(), weight=geom_w.numpy().copy(),
                       normal=normals.numpy().copy())
        return r

    def spy_lm(*a, **kw):
        r = lm_loop(*a, **kw)
        out.append(dict(pending, cost=float(r[4]), n_res=int(r[5]),
                        pose=[x.numpy().astype(np.float64) for x in r[:4]]))
        return r

    tslv._build_problem, tslv._lm_inner_loop = spy_build, spy_lm
    tslv.vm.moments_from_planes = spy_moments
    try:
        odo.registration.register_device(
            tmap, torch.from_numpy(np.asarray(cap["raw"])),
            torch.from_numpy(np.asarray(cap["alphas"])),
            torch.from_numpy(np.asarray(cap["valid"])), fr,
            prior=np.asarray(cap["prior"]), origin=cap["origin"],
            options=convert.options_from_dict(
                dataclasses.asdict(cap["options"]), topt.CTICPOptions))
    finally:
        tslv._build_problem, tslv._lm_inner_loop = build, lm_loop
        tslv.vm.moments_from_planes = moments
    return out, _poses(fr)


def lm_steps(odo, cap, it):
    """One LM call (the reference's iteration ``it``) on the reference's own
    problem arrays and start pose, in both packages, step by step: the
    reference's loop cut after s steps (``ls_max_num_iters`` = s) against
    the port's plain step (``kernels/lm_step.py::lm_step_plain``) s times;
    after each step the pose gap, both costs, and the port's accept, done,
    damping and the margin of J^T J's diagonal to the degeneracy test."""
    import jax
    import jax.numpy as jnp
    import torch

    from ct_icp_tpu.icp import solver as jslv
    from ct_icp_torch.config.options import LeastSquares
    from ct_icp_torch.kernels import lm_step as lm
    reg = odo.registration
    statics = reg.statics
    dyn_np = reg.dynamics(cap["options"])
    d0 = jslv.unpack_dynamics(dyn_np)
    raw, alphas = jnp.asarray(cap["raw"]), jnp.asarray(cap["alphas"])
    problem, start = it["problem"], it["start"]
    prior = jslv.unpack_prior(jnp.asarray(cap["prior"]))

    @jax.jit
    def after(steps):
        d = d0._replace(ls_max_num_iters=steps)
        anchors, normals, lines, cov_inv, geom_w, ok, cls, _ = problem
        return jslv._lm_inner_loop(statics, d, raw, alphas, anchors,
                                   normals, lines, cov_inv, geom_w, ok, cls,
                                   *start, prior)

    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    anchors, normals, _, _, geom_w, ok, _, _ = problem
    rows = lm.pack_rows(t(raw), t(alphas), t(anchors), t(normals),
                        t(geom_w), t(ok))
    state = lm.init_state(*(t(x) for x in start))
    n_res = t(ok).sum(dtype=torch.int32)
    out = []
    for s in range(1, min(int(d0.ls_max_num_iters), 64) + 1):
        if bool(state[lm.S_DONE] != 0):
            break
        cost_before = float(state[lm.S_COST0])
        lm.lm_step_plain(rows, t(cap["prior"]), n_res, state,
                         LeastSquares.CAUCHY, float(d0.ls_sigma),
                         float(d0.ls_tolerant_min_threshold), False)
        ref = after(jnp.int32(s))
        diag = torch.diagonal(state[lm.S_JTJ:lm.S_JTJ + 144].reshape(12, 12))
        ratio = (diag / diag.max()).numpy()
        port = [state[0:4].numpy(), state[4:7].numpy(),
                state[7:11].numpy(), state[11:14].numpy()]
        out.append(dict(
            step=s, pose_gap_m_deg=_gap([np.asarray(x) for x in ref[:4]],
                                        port),
            cost=[float(ref[4]), float(state[lm.S_COST0])],
            port_accept=bool(float(state[lm.S_COST1]) < cost_before)
            if s > 1 else None,
            port_done=bool(state[lm.S_DONE] != 0),
            port_lambda=float(state[lm.S_LAM]),
            degenerate=[int(i) for i in np.nonzero(ratio <= 1e-7)[0]],
            nearest_ratio_to_1e_7=float(ratio[np.argmin(np.abs(
                np.log(np.maximum(ratio, 1e-30)) - np.log(1e-7)))]),
            port_delta_norm=float(torch.linalg.norm(
                state[lm.S_DELTA:lm.S_DELTA + 12]))))
        print(json.dumps(out[-1]), flush=True)
    return out


def solver_dump(name, frame, attempt):
    odo, cap = capture_attempt(name, frame, attempt)
    ref = jax_iterations(odo, cap)
    got, port_end = port_iterations(name, cap)
    origin = cap["origin"]
    staged_end = [ref[-1]["pose"][0], ref[-1]["pose"][1] + origin,
                  ref[-1]["pose"][2], ref[-1]["pose"][3] + origin]
    for i, (a, b) in enumerate(zip(ref, got)):
        w = a["ok"] & b["ok"]
        print(json.dumps(dict(
            iteration=i,
            counts_differ=int((a["count"] != b["count"]).sum()),
            count_gap_max=int(np.abs(a["count"] - b["count"]).max()),
            ok_differ=int((a["ok"] != b["ok"]).sum()),
            n_ok=[int(a["ok"].sum()), int(b["ok"].sum())],
            weight_gap=float(np.abs(a["weight"] - b["weight"])[w].max()),
            weight_rel_gap=float((np.abs(a["weight"] - b["weight"])
                                  / np.maximum(np.abs(a["weight"]), 1e-30)
                                  )[w].max()),
            normal_gap=float(np.abs(np.abs(np.sum(a["normal"] * b["normal"],
                                                  -1)) - 1.0)[w].max()),
            cost=[a["cost"], b["cost"]],
            cost_rel_gap=abs(a["cost"] - b["cost"]) / max(abs(a["cost"]),
                                                          1e-30),
            n_res=[a["n_res"], b["n_res"]],
            pose_gap_m_deg=_gap(a["pose"], b["pose"]))), flush=True)
    parted = [i for i, (a, b) in enumerate(zip(ref, got))
              if _gap(a["pose"], b["pose"])[0] > 1e-5]
    if parted:
        print(json.dumps({"lm_steps_of_iteration": parted[0]}))
        lm_steps(odo, cap, ref[parted[0]])
    print(json.dumps(dict(
        run=name, frame=frame, attempt=attempt,
        iterations=[len(ref), len(got), cap["fused_iters"]],
        reference_fused_vs_staged_m_deg=_gap(cap["fused"], staged_end),
        port_vs_reference_fused_m_deg=_gap(port_end, cap["fused"]),
        port_vs_reference_staged_m_deg=_gap(port_end, staged_end))))


def nudge(odo, ulps):
    """Make ``odo``'s next registration attempt start from its initial end
    translation moved by ``ulps`` float32 ulps in x: one rounding of the
    reference's own, to see how far it moves from itself."""
    inner = odo.registration.register_device

    def spy(map_state, raw, alphas, valid, fr, **kw):
        x = np.float32(fr.end_pose.tr[0] - kw["origin"][0])
        for _ in range(abs(ulps)):
            x = np.nextafter(x, np.float32(np.sign(ulps) * np.inf))
        fr.end_pose.tr[0] = float(x) + kw["origin"][0]
        odo.registration.register_device = inner
        return inner(map_state, raw, alphas, valid, fr, **kw)

    odo.registration.register_device = spy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--seed", type=int, default=cor.APE_SEEDS[0])
    ap.add_argument("--runs", default=None)
    ap.add_argument("--per-frame", action="store_true")
    ap.add_argument("--port", nargs="*", default=[])
    ap.add_argument("--nudge", default="")
    ap.add_argument("--solver-dump", type=int, default=None)
    ap.add_argument("--attempt", type=int, default=0)
    a = ap.parse_args()
    if a.solver_dump is not None:
        solver_dump(a.runs or "adaptive_robust", a.solver_dump, a.attempt)
        return
    if a.per_frame:
        per_frame((a.runs or ",".join(rec.RUNS)).split(","), a.frames,
                  a.port, [int(u) for u in a.nudge.split(",") if u])
        return
    a.runs = a.runs or ("adaptive,adaptive_robust,cap,none:10,"
                        "adaptive_k2_cap:10")
    runs = []
    for r in (r for r in a.runs.split(",") if r):
        name, _, n = r.partition(":")
        runs.append((name, int(n) if n else a.frames))
    # the corridor of chip_smoke.py's driving phase: ``--frames`` frames
    # rendered, each run on the first of them
    scene = cor.build_scene()
    traj = cor.straight_trajectory(400, a.frames * 0.1 + 0.5)
    frames = cor.render_corridor(scene, traj, a.frames, a.seed)
    for name, n in runs:
        t0 = time.time()
        odo = Odometry(run_options(name))
        summaries = [odo.register_frame(f["xyz"], f["timestamps"],
                                        frame_id=i)
                     for i, f in enumerate(frames[:n])]
        errs = cor.seq_ape(odo, frames[:n])
        print(json.dumps({name: {
            "frames": n, "seed": a.seed,
            "mean_ape_m": float(np.mean(errs)),
            "max_ape_m": float(np.max(errs)),
            "failures": sum(not s.success for s in summaries),
            "mean_keypoints": float(np.mean(
                [s.sample_size for s in summaries[1:]])),
            "mean_attempts": float(np.mean(
                [s.number_of_attempts for s in summaries])),
            "seconds": time.time() - t0}}), flush=True)


if __name__ == "__main__":
    main()
