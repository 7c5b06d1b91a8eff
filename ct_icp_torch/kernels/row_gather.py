"""K6 row_gather: ``out[i] = table[slots[i]] - sub``, a zero row where the
slot is negative (or not below C); for one table, or for several tables at
the same slots in one launch (:func:`row_gather_fields`).

Replaces ``tools/exp_gather.py:90::dma_gather_kernel`` (wrapper
``dma_gather``, :112), the Pallas row gather by per-row DMAs with a ring of
8 copies in flight. That kernel's grid is ``n // 512`` blocks of 512 rows
(:114), so the rows past the last whole block are left unwritten there;
here every row is gathered. On the path it moves the rows of the map rebase
(``mapping/voxel_map.py::rebuild_level``): the reference's scatter
``zeros.at[dst].set(rows)`` written as the gather ``out[s] = rows[src[s]]``,
the points (minus the shift), normals, counts and flags in one launch that
reads ``src`` once.

Kernel: ``csrc/row_gather.cu`` — the output write is the unit of work: a
block takes a tile of rows, loads their slots into shared memory once and
walks the fields' contiguous outputs in 16-byte stores (4 elements, which
may belong to two rows), reading source elements only for rows with a slot
(16-, 8- or 4-byte loads as the width and the table's alignment allow).
Bound on the card: bytes, each distinct row read once, the slots and every
output element written once (``tools/exp_gather.py::k6_bytes``).

A table holds 4-byte elements (float32 or int32), [C, W], row-contiguous.
``sub`` (float32, float tables only) has W entries, or S entries with S
dividing W, entry ``j // (W // S)`` subtracted from column j (the rebase's
shift over the three planes of P points); ``None`` gives exp_gather's
function exactly. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

import ctypes

import torch

from ct_icp_torch.kernels import build

# launches of the CUDA kernel by row_gather and row_gather_fields (reset
# freely by callers)
launches = 0

_DTYPES = (torch.float32, torch.int32)
_MAX_WIDTH = 1 << 15        # the kernel's row = (e * recip) >> 32 is exact


def _expanded(sub, w):
    return sub if sub.numel() == w else sub.repeat_interleave(w // sub.numel())


def row_gather_plain(table, slots, sub=None):
    """Plain PyTorch version of :func:`row_gather` (indexing, the same zero
    and ``sub`` rules)."""
    ok = (slots >= 0) & (slots < table.shape[0])
    rows = table[torch.where(ok, slots, torch.zeros_like(slots)).long()]
    if sub is not None:
        rows = rows - _expanded(sub, table.shape[1])
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=table.dtype,
                                                      device=table.device))


def row_gather_fields_plain(tables, slots, subs=None):
    """Plain PyTorch version of :func:`row_gather_fields`: one
    :func:`row_gather_plain` a field."""
    subs = subs if subs is not None else (None,) * len(tables)
    return tuple(row_gather_plain(t, slots, s) for t, s in zip(tables, subs))


def row_gather(table, slots, sub=None):
    """Rows of ``table`` [C, W] at ``slots`` int32 [N], minus ``sub`` when
    given; a zero row where a slot is outside [0, C). Returns [N, W] of the
    table's dtype. The kernel of :func:`row_gather_fields` with one
    field."""
    return row_gather_fields((table,), slots, (sub,))[0]


def row_gather_fields(tables, slots, subs=None):
    """The rows of every table of ``tables`` ([C, W_f] each, one C) at
    ``slots`` int32 [N], minus ``subs[f]`` where given, zero rows where a
    slot is outside [0, C): a tuple of [N, W_f] of each table's dtype. One
    launch on the card."""
    if slots.device.type == "cpu":
        return row_gather_fields_plain(tables, slots, subs)
    global launches
    outs = launch(tables, slots, subs)
    launches += 1
    return outs


def launch(tables, slots, subs=None, defines=()):
    """One launch of ``csrc/row_gather.cu`` on CUDA tensors, counted by no
    launch counter; ``defines`` pick a measurement variant of the kernel
    (``tools/exp_rebase.py``), none the main path's."""
    dev = slots.device
    if dev.type != "cuda":
        raise ValueError(f"row_gather: no kernel for {dev}")
    nf = len(tables)
    subs = subs if subs is not None else (None,) * nf
    max_fields = build.launcher("row_gather", "k6_max_fields", ())()
    if not 1 <= nf <= max_fields or len(subs) != nf:
        raise ValueError(f"row_gather: 1 to {max_fields} tables, one sub "
                         f"each, got {nf} and {len(subs)}")
    n = slots.shape[0]
    c = tables[0].shape[0] if tables[0].dim() == 2 else -1
    build.check_tensor(slots, torch.int32, (n,), "row_gather", "slots", dev)
    outs, widths, reps, vecs = [], [], [], []
    max_sub_w = build.launcher("row_gather", "k6_max_sub_width", ())()
    sub_cols = 0
    for f, (table, sub) in enumerate(zip(tables, subs)):
        if table.dim() != 2 or table.dtype not in _DTYPES:
            raise ValueError("row_gather: tables must be 2-D float32 or int32 "
                             f"tensors, got {table.dtype} "
                             f"{tuple(table.shape)}")
        w = table.shape[1]
        build.check_tensor(table, table.dtype, (c, w), "row_gather",
                           f"table {f}", dev)
        if not 1 <= w <= _MAX_WIDTH or n * w >= 2 ** 31:
            raise ValueError(f"row_gather: table {f} width {w} for {n} rows")
        rep = 1
        if sub is not None:
            sub_cols += w
            if table.dtype != torch.float32 or sub.dim() != 1 or \
                    sub.numel() == 0 or w % sub.numel() or \
                    sub_cols > max_sub_w:
                raise ValueError(f"row_gather: sub {f} needs a float32 table "
                                 f"and a length dividing {w}, the tables "
                                 f"with a sub at most {max_sub_w} wide "
                                 "together")
            build.check_tensor(sub, torch.float32, (sub.numel(),),
                               "row_gather", f"sub {f}", dev)
            rep = w // sub.numel()
        ptr = table.data_ptr()
        vecs.append(4 if w % 4 == 0 and ptr % 16 == 0 else
                    2 if w % 2 == 0 and ptr % 8 == 0 else 1)
        out = torch.empty((n, w), dtype=table.dtype, device=dev)
        if out.data_ptr() % 16:
            raise RuntimeError("row_gather: an output off a 16-byte boundary")
        outs.append(out)
        widths.append(w)
        reps.append(rep)
    fn = build.launcher("row_gather", "k6_row_gather", _ARGTYPES, defines)
    status = fn(nf, (ctypes.c_void_p * nf)(*(t.data_ptr() for t in tables)),
                (ctypes.c_void_p * nf)(*(None if s is None else s.data_ptr()
                                         for s in subs)),
                (ctypes.c_void_p * nf)(*(o.data_ptr() for o in outs)),
                (ctypes.c_int * nf)(*widths), (ctypes.c_int * nf)(*reps),
                (ctypes.c_int * nf)(*vecs), build.ptr(slots), n, c,
                build.stream_of(slots))
    build.check_status(status, "row_gather")
    return tuple(outs)


_PTRS = ctypes.POINTER(ctypes.c_void_p)
_INTS = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = (build.INT, _PTRS, _PTRS, _PTRS, _INTS, _INTS, _INTS, build.PTR,
             build.INT, build.INT, build.PTR)
