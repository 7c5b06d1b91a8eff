"""K4 grid_sample: one representative point per voxel, compacted in scan
order.

Replaces ``tools/pallas_kernels_experiment.py:35::dedup_compact`` (the Pallas
claim-table sweep) and the operation it stands for,
``ct_icp_tpu/ops/sampling.py:27::voxel_subsample_indices``: truncated voxel
coords, the 3-prime hash masked to a 2^table_log2 table, the smallest scan
index of each slot wins (colliding voxels merge), a stable compaction capped
at ``capacity``. Kernel: ``csrc/grid_sample.cu`` — one cooperative launch:
a stamped ``atomicMin`` claim per valid point, a grid barrier, the kept
test and a block scan, a second barrier, the scatter and the zero fill.
The claim table and its stamp persist per device and table size
(:func:`_device_state`: 4 B a slot, 16.8 MB at table_log2 = 22), so no call
clears it; neither does its scratch. Bound on the card: bytes, the
points read once and the outputs written once (13 B a point, 5 B a slot of
the capacity); the table is the design's scratch and is not counted.

A CPU tensor takes :func:`grid_sample_plain`; a CUDA tensor launches the
kernel or raises.
"""

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.ops import voxel as vx

_NO_CLAIM = 2 ** 31 - 1

# launches of the CUDA kernel by grid_sample (reset freely by callers)
launches = 0
# (device, table_log2) -> (claim table int32, control block int32[1],
# block counts int32)
_tables = {}
# [most points a call takes, entries of the block counts]
_consts = []


def grid_sample_plain(points, valid, voxel_size: float, capacity: int,
                      table_log2: int = 22):
    """Plain PyTorch version of :func:`grid_sample` (the reference's
    scatter-min over a claim table, then ``compact_mask``)."""
    n = points.shape[0]
    t = 1 << table_log2
    dev = points.device
    h = vx.voxel_hash_u32(vx.voxel_coords(points, voxel_size)) & (t - 1)
    pid = torch.arange(n, dtype=torch.int32, device=dev)
    claim = torch.full((t + 1,), _NO_CLAIM, dtype=torch.int32, device=dev)
    claim.scatter_reduce_(0, torch.where(valid, h, torch.full_like(h, t)),
                          pid, "amin")
    mask = valid & (claim[h] == pid)
    idx, count, out_valid = vx.compact_mask_plain(mask, capacity)
    return idx, out_valid, count


def grid_sample(points, valid, voxel_size: float, capacity: int,
                table_log2: int = 22):
    """Voxel-grid subsample of ``points`` f32[N, 3] where ``valid`` bool[N]:
    returns (idx int32[capacity] into ``points``, kept in scan order and 0
    past the count; out_valid bool[capacity]; count, a 0-dim int32 tensor,
    min(kept, capacity)). One launch on the card; the three outputs share
    one allocation."""
    if points.device.type == "cpu":
        return grid_sample_plain(points, valid, voxel_size, capacity,
                                 table_log2)
    global launches
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"grid_sample: no kernel for {dev}")
    n = points.shape[0]
    max_n, block_ints = _constants()
    if not 2 <= table_log2 <= 30 or capacity < 0 or n > max_n:
        raise ValueError(f"grid_sample: need 2 <= table_log2 <= 30, "
                         f"capacity >= 0 and at most {max_n} points")
    build.check_tensor(points, torch.float32, (n, 3), "grid_sample",
                       "points", dev)
    build.check_tensor(valid, torch.bool, (n,), "grid_sample", "valid", dev)
    table, ctrl, block_cnt = _device_state(dev, table_log2, block_ints)
    # idx int32[capacity], the count int32, out_valid bool[capacity]
    buf = torch.empty((capacity * 5 + 4,), dtype=torch.uint8, device=dev)
    idx = buf[:4 * capacity].view(torch.int32)
    count = buf[4 * capacity:4 * capacity + 4].view(torch.int32)
    out_valid = buf[4 * capacity + 4:].view(torch.bool)
    fn = build.launcher("grid_sample", "k4_grid_sample", _ARGTYPES)
    status = fn(build.ptr(points), build.ptr(valid), n, float(voxel_size),
                int(table_log2), int(capacity), build.ptr(table),
                build.ptr(ctrl), build.ptr(block_cnt), build.ptr(idx),
                build.ptr(out_valid), build.ptr(count),
                build.stream_of(points))
    build.check_status(status, "grid_sample")
    launches += 1
    return idx, out_valid, count.reshape(())


def _constants():
    """(the most points a call takes, the int32 entries of the block
    counts), read from the library once."""
    if not _consts:
        _consts.extend(build.launcher("grid_sample", sym, ())()
                       for sym in ("k4_max_points", "k4_block_ints"))
    return _consts


def _device_state(dev, table_log2: int, block_ints: int):
    """The claim table (all ones at first), its control block (the last
    stamp, 0 at first) and the block counts that the kernel keeps from call
    to call for tables of 2^table_log2 slots on ``dev``: every call takes a
    new stamp, so no call clears the table."""
    key = (dev, table_log2)
    state = _tables.get(key)
    if state is None:
        state = _tables[key] = (
            torch.full((1 << table_log2,), -1, dtype=torch.int32,
                       device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.empty((block_ints,), dtype=torch.int32, device=dev))
    return state


_ARGTYPES = (build.PTR,) * 2 + (build.INT, build.FLOAT, build.INT, build.INT) \
    + (build.PTR,) * 7
