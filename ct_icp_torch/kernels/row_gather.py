"""K6 row_gather: ``out[i] = table[slots[i]] - sub``, a zero row where the
slot is negative (or not below C).

Replaces ``tools/exp_gather.py:90::dma_gather_kernel`` (wrapper
``dma_gather``, :112), the Pallas row gather by per-row DMAs with a ring of
8 copies in flight. That kernel's grid is ``n // 512`` blocks of 512 rows
(:114), so the rows past the last whole block are left unwritten there;
here every row is gathered. On the path it moves the rows of the map rebase
(``mapping/voxel_map.py::rebuild_level``): the reference's scatter
``zeros.at[dst].set(rows)`` written as the gather ``out[s] = rows[src[s]]``.

Kernel: ``csrc/row_gather.cu`` — consecutive threads on consecutive 16-byte
chunks of a row (4-byte chunks where W * 4 % 16 != 0): one warp a row at
W = 128. Bound on the card: bytes, 2 x N x W x 4 at 3.35 TB/s.

The table holds 4-byte elements (float32 or int32), [C, W], row-contiguous;
``sub`` (float32 [W], float tables only) is subtracted from every gathered
row; ``None`` gives exp_gather's function exactly. A CPU tensor takes
:func:`row_gather_plain`; a CUDA tensor launches the kernel or raises.
"""

import torch

from ct_icp_torch.kernels import build

# launches of the CUDA kernel by row_gather (reset freely by callers)
launches = 0

_DTYPES = (torch.float32, torch.int32)


def row_gather_plain(table, slots, sub=None):
    """Plain PyTorch version of :func:`row_gather` (indexing, the same zero
    and ``sub`` rules)."""
    ok = (slots >= 0) & (slots < table.shape[0])
    rows = table[torch.where(ok, slots, torch.zeros_like(slots)).long()]
    if sub is not None:
        rows = rows - sub
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=table.dtype,
                                                      device=table.device))


def row_gather(table, slots, sub=None):
    """Rows of ``table`` [C, W] at ``slots`` int32 [N], minus ``sub`` [W]
    when given; a zero row where a slot is outside [0, C). Returns [N, W]
    of the table's dtype."""
    if table.device.type == "cpu":
        return row_gather_plain(table, slots, sub)
    global launches
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"row_gather: no kernel for {dev}")
    if table.dim() != 2 or table.dtype not in _DTYPES:
        raise ValueError("row_gather: table must be a 2-D float32 or int32 "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
    c, w = table.shape
    n = slots.shape[0]
    build.check_tensor(table, table.dtype, (c, w), "row_gather", "table", dev)
    build.check_tensor(slots, torch.int32, (n,), "row_gather", "slots", dev)
    if sub is not None:
        if table.dtype != torch.float32:
            raise ValueError("row_gather: sub needs a float32 table")
        build.check_tensor(sub, torch.float32, (w,), "row_gather", "sub", dev)
    out = torch.empty((n, w), dtype=table.dtype, device=dev)
    vec4 = (w % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (table, out)
        + ((sub,) if sub is not None else ())))
    fn = build.launcher("row_gather", "k6_row_gather", _ARGTYPES)
    status = fn(build.ptr(table), build.ptr(slots),
                build.ptr(sub) if sub is not None else None, build.ptr(out),
                n, c, w, int(vec4), build.stream_of(table))
    build.check_status(status, "row_gather")
    launches += 1
    return out


_ARGTYPES = (build.PTR,) * 4 + (build.LONG, build.INT, build.INT, build.INT,
                                build.PTR)
