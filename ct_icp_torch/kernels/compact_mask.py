"""K16 compact_mask: a stable compaction of a bool mask, in scan order.

Replaces ``ct_icp_tpu/ops/voxel.py::compact_mask`` (:55), the XLA prefix
sum and scatter: the positions of the set entries of ``mask`` [N] in
increasing order, the first ``capacity`` of them, their count (clamped to
the capacity) and a validity mask; slots past the count hold 0. On the card
the port reaches it only from ``pipeline.device_decimation`` (the device
sub-sample path, and the device keypoint election with a residual cap);
K4 and K13 end with the same compaction inside their own launches, and the
plain versions of K3, K4 and K13 call :func:`compact_mask_plain`, so that
no plain version launches a kernel.

Kernel: ``csrc/compact_mask.cu`` — one cooperative launch on
``csrc/compact.cuh`` (ballot bits and a block scan, one grid barrier, the
ranked scatter and the zero fill), on per-device block-count scratch that
no call clears. Bound on the card: bytes, the mask read once (1 B an
entry) and the outputs written once (5 B a slot of the capacity).

A CPU tensor takes :func:`compact_mask_plain`; a CUDA tensor launches the
kernel or raises.
"""

import torch

from ct_icp_torch.kernels import build

THREADS = 256            # csrc/compact_mask.cu's block
MAX_TILES = 64           # tiles of THREADS entries a block
MAX_BLOCKS = 8192        # entries of the block counts

# launches of the CUDA kernel by compact_mask (reset freely by callers)
launches = 0
# per device: (block counts int32[MAX_BLOCKS], resident blocks)
_state = {}


def compact_mask_plain(mask, capacity: int):
    """Plain PyTorch version of :func:`compact_mask` (the reference's
    cumsum and scatter)."""
    n = mask.shape[0]
    dev = mask.device
    pid = torch.arange(n, dtype=torch.int32, device=dev)
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1
    dst = torch.where(mask & (pos < capacity), pos,
                      torch.full_like(pos, capacity)).to(torch.int64)
    idx = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    idx.scatter_(0, dst, pid)
    count = mask.sum(dtype=torch.int32)
    out_valid = torch.arange(capacity, dtype=torch.int32, device=dev) < count
    return idx[:capacity], torch.clamp_max(count, capacity), out_valid


def layout(n: int, resident_blocks: int):
    """(tiles a block, blocks) of a launch over ``n`` entries when
    ``resident_blocks`` blocks fit on the card at once: the fewest tiles a
    block that the resident blocks cover, then the blocks they need.
    Raises past ``resident_blocks * MAX_TILES * THREADS`` entries."""
    if n < 0:
        raise ValueError(f"compact_mask: {n} entries")
    most = min(resident_blocks, MAX_BLOCKS) * MAX_TILES * THREADS
    if n > most:
        raise ValueError(f"compact_mask: {n} entries, at most {most} on "
                         f"this card ({resident_blocks} resident blocks)")
    n_tiles = -(-n // THREADS)
    if n_tiles == 0:
        return 0, 1
    blocks_cap = min(resident_blocks, MAX_BLOCKS)
    tiles = -(-n_tiles // blocks_cap)
    return tiles, -(-n_tiles // tiles)


def compact_mask(mask, capacity: int):
    """Pack the True positions of ``mask`` bool[N] into the front of a
    buffer, in their original order.

    Returns (indices int32[capacity], count: a 0-dim int32 tensor,
    min(set entries, capacity); out_valid bool[capacity]). Slots beyond the
    count hold 0 and must stay masked. One launch on the card; the outputs
    share one allocation."""
    if mask.device.type == "cpu":
        return compact_mask_plain(mask, capacity)
    global launches
    dev = mask.device
    if dev.type != "cuda":
        raise ValueError(f"compact_mask: no kernel for {dev}")
    n = mask.shape[0]
    capacity = int(capacity)
    if capacity < 0:
        raise ValueError(f"compact_mask: capacity {capacity} < 0")
    build.check_tensor(mask, torch.bool, (n,), "compact_mask", "mask", dev)
    block_cnt, resident = _device_state(dev)
    tiles, blocks = layout(n, resident)
    # idx int32[capacity], the count int32, out_valid bool[capacity]
    buf = torch.empty((capacity * 5 + 4,), dtype=torch.uint8, device=dev)
    idx = buf[:4 * capacity].view(torch.int32)
    count = buf[4 * capacity:4 * capacity + 4].view(torch.int32)
    out_valid = buf[4 * capacity + 4:].view(torch.bool)
    fn = build.launcher("compact_mask", "k16_compact_mask", _ARGTYPES)
    status = fn(build.ptr(mask), n, tiles, blocks, capacity,
                build.ptr(block_cnt), build.ptr(idx), build.ptr(out_valid),
                build.ptr(count), build.stream_of(mask))
    build.check_status(status, "compact_mask")
    launches += 1
    return idx, count.reshape(()), out_valid


def _device_state(dev):
    """The block counts (scratch the kernel writes before its barrier) and
    the blocks resident at once on ``dev``, made once a device."""
    state = _state.get(dev)
    if state is None:
        with torch.cuda.device(dev):
            resident = build.launcher("compact_mask", "k16_resident_blocks",
                                      ())()
        if resident <= 0:
            raise RuntimeError(f"compact_mask: occupancy query failed "
                               f"(cudaError {-resident})")
        state = _state[dev] = (
            torch.empty((MAX_BLOCKS,), dtype=torch.int32, device=dev),
            resident)
    return state


_ARGTYPES = (build.PTR,) + (build.INT,) * 4 + (build.PTR,) * 5
