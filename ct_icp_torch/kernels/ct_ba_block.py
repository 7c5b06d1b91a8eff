"""K8 ct_ba_block: the per-keyframe Gauss-Newton block of the CT-BA backend.

Replaces ``ct_icp_tpu/parallel/ct_ba.py:120-152`` (``_frame_gn_update``,
vmapped over the window by the block-Jacobi ``local_step``) and
``:170-198`` (``_frame_blocks``, the coupled solver's row pass). One launch
of ``csrc/ct_ba_block.cu`` does, for every keyframe of the window at once:

  * mode ``"gn"``: one block-Jacobi inner iteration: the residual of the K
    point rows, the 8 continuity rows (against the neighbours' previous
    iterate) and the 8 prior rows, their 12-tangent forward-mode Jacobian,
    J^T J and J^T r, the Jacobi-scaled damped 12x12 solve and the updated
    pose; the cost with the continuity rows halved;
  * mode ``"blocks"``: J^T J, J^T r and the cost of the point and prior
    rows only (the coupled solver adds its edges in torch).

Each frame's rows are split over CTAs of 256 rows; the last CTA of a frame
to finish sums their partials in CTA order (an integer counter, no float
atomics: a run repeats bit for bit) and does the pose-level work. Bound on
the card: bytes (44 B a row) or operations (850-1,000 a row), ~0.4-0.5 us
at the backend's window (F = 8, K = 4,096); the launch is latency-bound.

A CPU tensor takes :func:`ct_ba_block_plain` (the same row pass over
``core/dual.py``: ``parallel/ct_ba.py::_frame_gn_update`` and
``_frame_blocks``); a CUDA tensor launches the kernel or raises.
"""

from typing import NamedTuple, Optional

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.parallel import ct_ba as ba

SUMS = 91            # 78 of J^T J, 12 of J^T r, 1 r^2
MODES = {"gn": 0, "blocks": 1}

# launches of the CUDA kernel by ct_ba_block (reset freely by callers)
launches = 0
# per device, the frame counters of the last-CTA handoff (zero between
# launches: each launch leaves them zero)
_counters = {}


class Block(NamedTuple):
    poses: Optional[torch.Tensor]   # f32 [F, 14] the updated poses ("gn")
    cost: torch.Tensor              # f32 [F]
    jtj: torch.Tensor               # f32 [F, 12, 12] (hp in "blocks")
    jtr: torch.Tensor               # f32 [F, 12]     (gp in "blocks")


def ct_ba_block_plain(poses, problem, beta: float, damping: float,
                      mode: str) -> Block:
    """Plain PyTorch version of :func:`ct_ba_block`."""
    if mode == "gn":
        return Block(*ba._frame_gn_update(poses, problem, beta, damping))
    if mode == "blocks":
        hp, gp, cost = ba._frame_blocks(poses, problem)
        return Block(None, cost, hp, gp)
    raise ValueError(f"ct_ba_block: unknown mode {mode!r}")


def ct_ba_block(poses, problem, beta: float, damping: float,
                mode: str) -> Block:
    """One block pass over the window: ``poses`` f32[F, 14] (qb, tb, qe,
    te: the previous iterate), ``problem`` a ``parallel.ct_ba.CTBAProblem``
    (raw, anchors, normals f32[F, K, 3]; alphas, weights f32[F, K]; the
    prior poses; prior_weight and edge_alpha f32[F]), the continuity weight
    ``beta`` and the damping. Returns a :class:`Block`; nothing is read
    back. One launch of ``csrc/ct_ba_block.cu`` on the card."""
    if poses.device.type == "cpu":
        return ct_ba_block_plain(poses, problem, beta, damping, mode)
    global launches
    dev = poses.device
    if dev.type != "cuda":
        raise ValueError(f"ct_ba_block: no kernel for {dev}")
    if mode not in MODES:
        raise ValueError(f"ct_ba_block: unknown mode {mode!r}")
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
    splits = build.launcher("ct_ba_block", "k8_splits", (build.INT,))(k)
    gn = mode == "gn"
    new = torch.empty((f, 14), dtype=f32, device=dev) if gn else None
    cost = torch.empty((f,), dtype=f32, device=dev)
    jtj = torch.empty((f, 12, 12), dtype=f32, device=dev)
    jtr = torch.empty((f, 12), dtype=f32, device=dev)
    partial = torch.empty((f, splits, SUMS), dtype=f32, device=dev)
    fn = build.launcher("ct_ba_block", "k8_ct_ba_block", _ARGTYPES)
    status = fn(build.ptr(poses), None if new is None else build.ptr(new),
                *(build.ptr(t) for t in (
                    p.raw, p.alphas, p.anchors, p.normals, p.weights,
                    p.prior_quat_begin, p.prior_tr_begin, p.prior_quat_end,
                    p.prior_tr_end, p.prior_weight, p.edge_alpha)),
                f, k, splits, float(beta), float(damping), MODES[mode],
                build.ptr(partial), build.ptr(_counter_buffer(dev, f)),
                build.ptr(cost), build.ptr(jtj), build.ptr(jtr),
                build.stream_of(poses))
    build.check_status(status, "ct_ba_block")
    launches += 1
    return Block(new, cost, jtj, jtr)


def _counter_buffer(dev, f: int):
    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    buf = _counters.get(dev)
    if buf is None or buf.numel() < f:
        buf = _counters[dev] = torch.zeros(max(f, 64), dtype=torch.int32,
                                           device=dev)
    return buf


_ARGTYPES = (build.PTR,) * 13 + (build.INT,) * 3 + (build.FLOAT,) * 2 \
    + (build.INT,) + (build.PTR,) * 6
