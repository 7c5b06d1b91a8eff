"""K8 ct_ba_block: the per-keyframe Gauss-Newton blocks of the CT-BA backend.

Replaces ``ct_icp_tpu/parallel/ct_ba.py:120-152`` (``_frame_gn_update``,
vmapped over the window by the block-Jacobi ``local_step`` inside its
``fori_loop`` over the inner iterations) and ``:170-198``
(``_frame_blocks``, the coupled solver's row pass). One launch of
``csrc/ct_ba_block.cu`` does, for every keyframe of the window at once:

  * mode ``"gn"``: ``iters`` block-Jacobi inner iterations: the residual of
    the K point rows, the 8 continuity rows (against the neighbours'
    previous iterate) and the 8 prior rows, their 12-tangent forward-mode
    Jacobian, J^T J and J^T r, the Jacobi-scaled damped 12x12 solve and the
    updated pose, each iteration on the previous one's poses; the last
    iteration's cost with the continuity rows halved, and its total;
  * mode ``"blocks"`` (one iteration): J^T J, J^T r and the cost of the
    point and prior rows only (the coupled solver adds its edges in torch).

A single-iteration ``"gn"`` launch may take a ``halo`` f32[2, 16]: the
neighbours of the window's first and last frame where the window is one
rank's slice of a sharded window (``parallel/ct_ba.py``'s mesh step): row 0
the previous frame's iterate (14), its edge_alpha and 1 (0: no such
edge), row 1 the next frame's iterate (14), 0 and 1 or 0
(:func:`ct_ba.halo_rows`). The kernel extrapolates the previous frame
itself, as it does a neighbour inside the window, so a rank's launch
repeats the one-device launch's rows bit for bit.

Each frame is a thread-block cluster (16 CTAs, or 8 where the window's
clusters do not all fit on the card at once: :func:`cluster_size`) that
keeps its rows in shared memory for the whole launch; its partial sums meet
in rank order through distributed shared memory, and a frame waits only for
its two neighbours' previous iterate (an iteration flag a frame). No float
atomics: a launch repeats bit for bit, and one launch of ``iters``
iterations equals ``iters`` launches of one. Bound on the card: bytes (44 B
a row) or operations (850-1,000 a row an iteration), ~0.4-0.5 us an
iteration at the backend's window (F = 8, K = 4,096); the launch is bound
by its serial chain an iteration.

A CPU tensor takes :func:`ct_ba_block_plain` (the same row pass over
``core/dual.py``: ``parallel/ct_ba.py::_frame_gn_update`` in a loop, and
``_frame_blocks``); a CUDA tensor launches the kernel or raises, also where
a multi-iteration window's clusters cannot all be resident.
"""

from typing import NamedTuple, Optional

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.parallel import ct_ba as ba

MODES = {"gn": 0, "blocks": 1}
# the -DK8_MARKS variant's clock marks (tools/exp_ct_ba.py): for each of
# MARK_SLOTS marked CTAs (ranks 0 and 1 of frame 0) the cycles of each
# phase, its calls, and its span in globaltimer ns and in clock cycles
MARK_PHASES = ("rows in + first tangents", "barrier A + tangent copy",
               "row pass", "CTA sums", "barrier B", "cluster sums",
               "J^T J assembly", "solve + new pose", "new tangents",
               "pose warp: neighbour wait", "pose warp: pose rows",
               "last cluster + total", "calls", "span ns", "span cycles")
MARK_SLOTS = 2
# the kernel's other measurement variants (tools/exp_ct_ba.py)
VARIANTS = {"dual.cuh divisions": ("K8_IEEE_DUAL",)}

# launches of the CUDA kernel by ct_ba_block (reset freely by callers)
launches = 0
# per device: the int32 [1 + F] finished-cluster counter and iteration
# flags (zero between launches: each launch leaves them zero), and the
# f32 [2, F, 14] iterates the neighbours read
_flags = {}
_iterates = {}
# per (device, F, K): the CTAs of a frame's cluster (csrc k8_cluster)
_clusters = {}


class Block(NamedTuple):
    poses: Optional[torch.Tensor]   # f32 [F, 14] the updated poses ("gn")
    cost: torch.Tensor              # f32 [F]
    jtj: torch.Tensor               # f32 [F, 12, 12] (hp in "blocks")
    jtr: torch.Tensor               # f32 [F, 12]     (gp in "blocks")
    total: torch.Tensor             # f32 [] the costs summed in frame order


def frame_order_sum(cost):
    """The frames' costs summed one after another in frame order (the
    kernel's order), a 0-dim tensor."""
    total = cost[0]
    for f in range(1, cost.shape[0]):
        total = total + cost[f]
    return total


def ct_ba_block_plain(poses, problem, beta: float, damping: float,
                      mode: str, iters: int = 1, halo=None) -> Block:
    """Plain PyTorch version of :func:`ct_ba_block`: ``iters`` calls of
    ``_frame_gn_update``, each on the previous one's poses (the reference's
    ``one_iter``), or ``_frame_blocks``."""
    _check_iters(mode, iters, halo)
    if mode == "gn":
        for _ in range(iters):
            poses, cost, jtj, jtr = ba._frame_gn_update(poses, problem, beta,
                                                        damping, halo)
        return Block(poses, cost, jtj, jtr, frame_order_sum(cost))
    hp, gp, cost = ba._frame_blocks(poses, problem)
    return Block(None, cost, hp, gp, frame_order_sum(cost))


def _check_iters(mode, iters, halo=None):
    if mode not in MODES:
        raise ValueError(f"ct_ba_block: unknown mode {mode!r}")
    if iters < 1 or (mode == "blocks" and iters != 1):
        raise ValueError(f"ct_ba_block: {iters} iterations in mode {mode!r}")
    if halo is not None and (mode != "gn" or iters != 1):
        raise ValueError("ct_ba_block: a halo takes one 'gn' iteration")


def ct_ba_block(poses, problem, beta: float, damping: float, mode: str,
                iters: int = 1, halo=None) -> Block:
    """Block passes over the window: ``poses`` f32[F, 14] (qb, tb, qe, te:
    the first iterate), ``problem`` a ``parallel.ct_ba.CTBAProblem`` (raw,
    anchors, normals f32[F, K, 3]; alphas, weights f32[F, K]; the prior
    poses; prior_weight and edge_alpha f32[F]), the continuity weight
    ``beta``, the damping, the inner iterations (``"gn"``) and the halo of
    a rank's slice (single-iteration ``"gn"`` only). Returns a
    :class:`Block` of the last iteration; nothing is read back. One launch
    of ``csrc/ct_ba_block.cu`` on the card."""
    if poses.device.type == "cpu":
        # the halo only where there is one: the plain version's callers
        # (and stand-ins for it) keep its six-argument form
        return ct_ba_block_plain(poses, problem, beta, damping, mode, iters,
                                 *(() if halo is None else (halo,)))
    global launches
    out = launch(poses, problem, beta, damping, mode, iters, halo=halo)
    launches += 1
    return out


def _resident_cluster(f: int, k: int, dev) -> int:
    """``csrc`` ``k8_cluster``: the CTAs of a frame's cluster (16 or 8) with
    which all ``f`` clusters of ``k`` rows are resident on ``dev`` at once,
    0 where neither size fits (the occupancy API, cached)."""
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev, f, k)
    c = _clusters.get(key)
    if c is None:
        c = build.launcher("ct_ba_block", "k8_cluster",
                           (build.INT, build.INT))(f, k)
        if c < 0:
            build.check_status(-c, "ct_ba_block")
        _clusters[key] = c
    return c


def resident(f: int, k: int, dev) -> bool:
    """Whether one launch of several inner iterations over ``f`` frames of
    ``k`` rows fits on ``dev``: every frame's cluster resident at once (a
    frame waits on its neighbours' iteration flags), or a single frame.
    Never raises for a window that does not fit."""
    return f <= 1 or _resident_cluster(f, k, dev) != 0


def max_resident_frames(k: int, dev, most: int = 4096) -> int:
    """The largest window (frames of ``k`` rows, at most ``most``) whose
    multi-iteration launch fits on ``dev`` (:func:`resident`)."""
    lo, hi = 1, most
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if resident(mid, k, dev) else (lo, mid - 1)
    return lo


def cluster_size(f: int, k: int, dev, waits: bool = True) -> int:
    """The CTAs of a frame's cluster for a window of ``f`` frames of ``k``
    rows on ``dev``: 16, or 8 where ``f`` clusters of 16 cannot all be
    resident at once. A launch whose clusters wait for each other
    (``waits``: several iterations of several frames) raises where ``f``
    clusters of 8 cannot be resident either (:func:`resident` asks
    without raising); one that does not takes 16."""
    c = _resident_cluster(f, k, dev)
    if c == 0 and waits:
        raise ValueError(f"ct_ba_block: the {f} clusters of a multi-iteration "
                         f"launch cannot all be resident on {dev}")
    return c or 16


def launch(poses, problem, beta: float, damping: float, mode: str,
           iters: int = 1, defines=(), halo=None) -> Block:
    """One launch of ``csrc/ct_ba_block.cu`` on CUDA tensors, counted by no
    launch counter; ``defines`` pick a measurement variant of the kernel
    (``tools/exp_ct_ba.py``), none the main path's."""
    dev = poses.device
    if dev.type != "cuda":
        raise ValueError(f"ct_ba_block: no kernel for {dev}")
    _check_iters(mode, iters, halo)
    p = problem
    f, k = p.raw.shape[0], p.raw.shape[1]
    f32 = torch.float32
    for t, shape, name in (
            (poses, (f, 14), "poses"), (p.raw, (f, k, 3), "raw"),
            (p.alphas, (f, k), "alphas"), (p.anchors, (f, k, 3), "anchors"),
            (p.normals, (f, k, 3), "normals"), (p.weights, (f, k), "weights"),
            (p.prior_quat_begin, (f, 4), "prior_quat_begin"),
            (p.prior_tr_begin, (f, 3), "prior_tr_begin"),
            (p.prior_quat_end, (f, 4), "prior_quat_end"),
            (p.prior_tr_end, (f, 3), "prior_tr_end"),
            (p.prior_weight, (f,), "prior_weight"),
            (p.edge_alpha, (f,), "edge_alpha")):
        build.check_tensor(t, f32, shape, "ct_ba_block", name, dev)
    if halo is not None:
        build.check_tensor(halo, f32, (2, 16), "ct_ba_block", "halo", dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cluster = cluster_size(f, k, dev, waits=iters > 1 and f > 1)
    gn = mode == "gn"
    new = torch.empty((f, 14), dtype=f32, device=dev) if gn else None
    cost = torch.empty((f,), dtype=f32, device=dev)
    total = torch.empty((), dtype=f32, device=dev)
    jtj = torch.empty((f, 12, 12), dtype=f32, device=dev)
    jtr = torch.empty((f, 12), dtype=f32, device=dev)
    fn = build.launcher("ct_ba_block", "k8_ct_ba_block", _ARGTYPES, defines)
    status = fn(build.ptr(poses), None if new is None else build.ptr(new),
                build.ptr(_buffer(_iterates, dev, (2, f, 14), f32)),
                *(build.ptr(t) for t in (
                    p.raw, p.alphas, p.anchors, p.normals, p.weights,
                    p.prior_quat_begin, p.prior_tr_begin, p.prior_quat_end,
                    p.prior_tr_end, p.prior_weight, p.edge_alpha)),
                None if halo is None else build.ptr(halo), f, k, cluster,
                float(beta), float(damping), MODES[mode], int(iters),
                build.ptr(_buffer(_flags, dev, (1 + f,), torch.int32)),
                build.ptr(cost), build.ptr(total), build.ptr(jtj),
                build.ptr(jtr), build.stream_of(poses))
    build.check_status(status, "ct_ba_block")
    return Block(new, cost, jtj, jtr, total)


def _buffer(store, dev, shape, dtype):
    """A flat per-device buffer of at least the elements of ``shape``, zero
    when made; a larger request makes a larger one."""
    n = 1
    for s in shape:
        n *= s
    buf = store.get(dev)
    if buf is None or buf.numel() < n:
        buf = store[dev] = torch.zeros(max(n, 1024), dtype=dtype, device=dev)
    return buf


_ARGTYPES = (build.PTR,) * 15 + (build.INT,) * 3 + (build.FLOAT,) * 2 \
    + (build.INT,) * 2 + (build.PTR,) * 6
