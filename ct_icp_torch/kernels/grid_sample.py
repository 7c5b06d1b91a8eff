"""K4 grid_sample: one representative point per voxel, compacted in scan
order.

Replaces ``tools/pallas_kernels_experiment.py:35::dedup_compact`` (the Pallas
claim-table sweep) and the operation it stands for,
``ct_icp_tpu/ops/sampling.py:27::voxel_subsample_indices``: truncated voxel
coords, the 3-prime hash masked to a 2^table_log2 table, the smallest scan
index of each slot wins (colliding voxels merge), a stable compaction capped
at ``capacity``. Kernel: ``csrc/grid_sample.cu`` — a table clear, one
``atomicMin`` per valid point, a block count, a scan of the counts and a
block-scan scatter; five launches, no host sync. Bound on the card: bytes,
dominated by clearing the table (16.8 MB at table_log2 = 22).

A CPU tensor takes :func:`grid_sample_plain`; a CUDA tensor launches the
kernel or raises.
"""

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.ops import voxel as vx

_NO_CLAIM = 2 ** 31 - 1

# launches of the CUDA kernel by grid_sample (reset freely by callers)
launches = 0


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
    idx, count, out_valid = vx.compact_mask(mask, capacity)
    return idx, out_valid, count


def grid_sample(points, valid, voxel_size: float, capacity: int,
                table_log2: int = 22):
    """Voxel-grid subsample of ``points`` f32[N, 3] where ``valid`` bool[N]:
    returns (idx int32[capacity] into ``points``, kept in scan order and 0
    past the count; out_valid bool[capacity]; count, a 0-dim int32 tensor,
    min(kept, capacity))."""
    if points.device.type == "cpu":
        return grid_sample_plain(points, valid, voxel_size, capacity,
                                 table_log2)
    global launches
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"grid_sample: no kernel for {dev}")
    n = points.shape[0]
    t = 1 << table_log2
    if not 2 <= table_log2 <= 30 or capacity < 0:
        raise ValueError("grid_sample: need 2 <= table_log2 <= 30 and "
                         "capacity >= 0")
    build.check_tensor(points, torch.float32, (n, 3), "grid_sample",
                       "points", dev)
    build.check_tensor(valid, torch.bool, (n,), "grid_sample", "valid", dev)
    i32 = dict(dtype=torch.int32, device=dev)
    table = torch.empty((t,), **i32)
    slot = torch.empty((max(n, 1),), **i32)
    block_cnt = torch.empty((max((n + 1023) // 1024, 1),), **i32)
    idx = torch.empty((capacity,), **i32)
    out_valid = torch.empty((capacity,), dtype=torch.bool, device=dev)
    count = torch.empty((1,), **i32)
    fn = build.launcher("grid_sample", "k4_grid_sample", _ARGTYPES)
    status = fn(build.ptr(points), build.ptr(valid), n, float(voxel_size),
                int(table_log2), int(capacity), build.ptr(table),
                build.ptr(slot), build.ptr(block_cnt), build.ptr(idx),
                build.ptr(out_valid), build.ptr(count),
                build.stream_of(points))
    build.check_status(status, "grid_sample")
    launches += 1
    return idx, out_valid, count.reshape(())


_ARGTYPES = (build.PTR,) * 2 + (build.INT, build.FLOAT, build.INT, build.INT) \
    + (build.PTR,) * 7
