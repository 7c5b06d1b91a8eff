"""K13 exact_sample: up to ``k`` points a voxel, grouped by the exact voxel
key, kept in scan order.

Replaces the JAX package's exact samplers, XLA lexsorts that reach no
Pallas kernel: ``ct_icp_tpu/ops/sampling.py:61::voxel_subsample_indices_
exact`` (k = 1, one voxel size), ``:73::voxel_sample_k_indices`` (k > 1)
and ``:89::adaptive_grid_sampling_indices`` (distance bands, a voxel size
each, and a global cap ``max_keep``). Point i is kept iff it is valid (and,
with bands, in range) and fewer than ``k`` valid, in-range points j < i
share its key (band, trunc(x/s), trunc(y/s), trunc(z/s)); then only the
first ``max_keep`` kept points stay (``max_keep`` <= 0: all), compacted in
scan order to ``capacity`` (``ops/voxel.py::compact_mask``'s contract).
With bands a point's range is d = sqrt(fma(z, z, fma(y, y, x*x))): the
JAX package's ``jnp.linalg.norm``, which XLA contracts into these two FMAs
on the CPU (see :func:`range_f32`). Kernel: ``csrc/exact_sample.cu``, one
cooperative launch: one insert pass with no grid barrier in it over a table
of 2^ceil(log2 4N) slots (the first point to reach a free slot claims it by
atomicCAS and publishes its 16-byte key; the others wait for the key and
compare all four words: no two voxels merge), the election of each key's
earliest point in the same pass (an atomicMin of stamped scan indices, one
a warp's lanes that share a slot), ``k - 1`` rank rounds, a block-scan
compaction: two grid barriers a call at k = 1. The table persists per
device and size (28 B a slot: 7.3 MB at N = 65,536), so no call clears it.
Bound on the card: bytes, the points and flags read once and the outputs
written once (13 B a point, 5 B a slot of the capacity), as K4's; the table
and the per-point scratch are the design's and are not counted. What holds
it above the bound is latency (the grid barriers, the dependent claim and
read of random table words), which the one pass keeps to two barriers.

A CPU tensor takes :func:`exact_sample_plain`; a CUDA tensor launches the
kernel or raises.
"""

import ctypes

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.ops import voxel as vx

# launches of the CUDA kernel by exact_sample (reset freely by callers)
launches = 0
# (device, table_log2) -> (claim words int64, keys int32 [T, 4], stamps
# int32, the last stamp int32[1], block counts int32)
_tables = {}
# [the most bands, the largest k, entries of the block counts]
_consts = []


def table_log2_for(n: int) -> int:
    """log2 of the table's slots for ``n`` points: 2^ceil(log2 4n), at
    least 2^10, so every claimant finds a slot."""
    return max(10, (4 * max(n, 1) - 1).bit_length())


def _fma_f32(a, b, c):
    """float32 a * b + c rounded once, as ``__fmaf_rn``: a * b is exact in
    float64 and the sum is rounded there with its error e (TwoSum); the
    float32 rounding of that sum can differ from the exact one's only where
    it lies halfway between two float32 values and e is not 0, and there
    it is moved one float64 step toward e."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.float()
    other = torch.nextafter(r, torch.where(s > r.double(),
                                           torch.full_like(r, float("inf")),
                                           torch.full_like(r, -float("inf"))))
    tie = (s == (r.double() + other.double()) * 0.5) & (e != 0)
    toward = torch.where(e > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, -float("inf")))
    s = torch.where(tie, torch.nextafter(s, toward), s)
    return s.float()


def range_f32(points):
    """The range of each point as the JAX package computes it on the CPU:
    sqrt(fma(z, z, fma(y, y, x * x))) in float32 (XLA contracts the norm's
    squares and sums into two FMAs), each step rounded once. The square
    root is taken in float64 and rounded to float32, which is the correctly
    rounded float32 root (torch's vectorized float32 sqrt on the CPU is
    not, at the last ulp)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    return torch.sqrt(_fma_f32(z, z, _fma_f32(y, y, x * x)).double()).float()


def sample_keys(points, valid, voxel_size=None, bands=None):
    """(keys int32 [N, 4]: band, cx, cy, cz; ok bool [N]): the exact key of
    each point and whether it takes part (valid, and in range with
    ``bands``, a sequence of (edge, size) pairs)."""
    dev = points.device
    n = points.shape[0]
    if bands is None:
        band = torch.zeros((n, 1), dtype=torch.int32, device=dev)
        return (torch.cat([band, vx.voxel_coords(points, voxel_size)], 1),
                valid)
    f32 = dict(dtype=torch.float32, device=dev)
    edges = torch.tensor([float(b[0]) for b in bands], **f32)
    sizes = torch.tensor([float(b[1]) for b in bands], **f32)
    d = range_f32(points)
    band = (edges[None, :] < d[:, None]).sum(1) - 1
    ok = valid & (d >= edges[0]) & (d < edges[-1])
    band = torch.clamp(band, 0, len(bands) - 1)
    s = sizes[band]
    s = torch.where(s > 0, s, torch.ones_like(s))
    coords = torch.trunc(points / s[:, None]).to(torch.int32)
    return torch.cat([band.to(torch.int32)[:, None], coords], 1), ok


def exact_sample_plain(points, valid, capacity: int, voxel_size=None,
                       bands=None, k: int = 1, max_keep: int = 0):
    """Plain PyTorch version of :func:`exact_sample`, in the kernel's
    rounds: the exact grouping (``torch.unique`` of the key rows), ``k``
    rounds of a scatter-min of the unelected scan indices a group, the
    global cap, then ``compact_mask``."""
    n = points.shape[0]
    dev = points.device
    keys, ok = sample_keys(points, valid, voxel_size, bands)
    # group n: the points that take no part
    gid = torch.full((n,), n, dtype=torch.int64, device=dev)
    _, inv = torch.unique(keys[ok], dim=0, return_inverse=True)
    gid[ok] = inv.reshape(-1)
    pid = torch.arange(n, dtype=torch.int64, device=dev)
    kept = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(k):
        cand = ok & ~kept
        win = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
        win.scatter_reduce_(0, torch.where(cand, gid, torch.full_like(gid, n)),
                            pid, "amin")
        kept |= cand & (win[gid] == pid)
    if max_keep > 0:
        kept &= torch.cumsum(kept.to(torch.int32), 0) <= max_keep
    idx, count, out_valid = vx.compact_mask_plain(kept, capacity)
    return idx, out_valid, count


def exact_sample(points, valid, capacity: int, voxel_size=None, bands=None,
                 k: int = 1, max_keep: int = 0):
    """Up to ``k`` points a voxel of ``points`` f32[N, 3] where ``valid``
    bool[N], grouped by the exact key at ``voxel_size`` or, with ``bands``
    ((edge, size) pairs, edges ascending), at the size of each point's
    range band; then the first ``max_keep`` (<= 0: all). Returns (idx
    int32[capacity] into ``points``, in scan order and 0 past the count;
    out_valid bool[capacity]; count, a 0-dim int32 tensor). One launch on
    the card; the three outputs share one allocation."""
    if (bands is None) == (voxel_size is None):
        raise ValueError("exact_sample: give voxel_size or bands")
    if k < 1:
        raise ValueError("exact_sample: k must be >= 1")
    if points.device.type == "cpu":
        return exact_sample_plain(points, valid, capacity, voxel_size, bands,
                                  k, max_keep)
    global launches
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"exact_sample: no kernel for {dev}")
    n = points.shape[0]
    max_bands, max_k, block_ints = _constants()
    n_bands = 0 if bands is None else len(bands)
    if n_bands > max_bands or k > max_k or capacity < 0:
        raise ValueError(f"exact_sample: at most {max_bands} bands, "
                         f"k <= {max_k} and capacity >= 0")
    build.check_tensor(points, torch.float32, (n, 3), "exact_sample",
                       "points", dev)
    build.check_tensor(valid, torch.bool, (n,), "exact_sample", "valid", dev)
    log2 = table_log2_for(n)
    claim, tkey, tstamp, ctrl, block_cnt = _device_state(dev, log2,
                                                         block_ints)
    scratch = torch.empty((max(n, 1),), dtype=torch.int32, device=dev)
    # idx int32[capacity], the count int32, out_valid bool[capacity]
    buf = torch.empty((capacity * 5 + 4,), dtype=torch.uint8, device=dev)
    idx = buf[:4 * capacity].view(torch.int32)
    count = buf[4 * capacity:4 * capacity + 4].view(torch.int32)
    out_valid = buf[4 * capacity + 4:].view(torch.bool)
    edges = (ctypes.c_float * max(n_bands, 1))(
        *[float(b[0]) for b in bands or ()])
    sizes = (ctypes.c_float * max(n_bands, 1))(
        *[float(b[1]) for b in bands or ()])
    fn = build.launcher("exact_sample", "k13_exact_sample", _ARGTYPES)
    status = fn(build.ptr(points), build.ptr(valid), n,
                float(voxel_size or 0.0), edges, sizes, n_bands, int(k),
                int(max_keep), log2, int(capacity), build.ptr(claim),
                build.ptr(tkey), build.ptr(tstamp), build.ptr(ctrl),
                build.ptr(block_cnt), build.ptr(scratch), build.ptr(idx),
                build.ptr(out_valid), build.ptr(count),
                build.stream_of(points))
    build.check_status(status, "exact_sample")
    launches += 1
    return idx, out_valid, count.reshape(())


def _constants():
    """(the most bands, the largest k, the int32 entries of the block
    counts), read from the library once."""
    if not _consts:
        _consts.extend(build.launcher("exact_sample", sym, ())()
                       for sym in ("k13_max_bands", "k13_max_k",
                                   "k13_block_ints"))
    return _consts


def _device_state(dev, table_log2: int, block_ints: int):
    """The table (claim words all ones, stamps 0 at first; keys read only
    where a slot's stamp is the call's), the last stamp (0 at first) and
    the block counts that the kernel keeps from call to call for tables of
    2^table_log2 slots on ``dev``: every call takes a new stamp, so no call
    clears the table."""
    key = (dev, table_log2)
    state = _tables.get(key)
    if state is None:
        t = 1 << table_log2
        state = _tables[key] = (
            torch.full((t,), -1, dtype=torch.int64, device=dev),
            torch.empty((t, 4), dtype=torch.int32, device=dev),
            torch.zeros((t,), dtype=torch.int32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.empty((block_ints,), dtype=torch.int32, device=dev))
    return state


_FLOATS = ctypes.POINTER(ctypes.c_float)
_ARGTYPES = ((build.PTR,) * 2 + (build.INT, build.FLOAT, _FLOATS, _FLOATS)
             + (build.INT,) * 5 + (build.PTR,) * 10)
