"""The cost law of the row gathers and scatters of the odometry's hot path,
on the card (the port of ``tools/exp_gather.py``).

    python -m ct_icp_torch.tools.exp_gather

Questions, as the original asks them:
  1. is ``table[slots]`` cost per row or per byte? (N rows x row width)
  2. does a narrower type (f32 -> int16) pay?
  3. what does the compaction of an index mask cost (``ops/voxel.py::
     compact_mask``, the prefix-sum pack)?
  4. what does the hand-written row gather sustain: K6 ``row_gather``
     (``kernels/row_gather.py``), the port of the Pallas
     ``dma_gather_kernel`` (``tools/exp_gather.py:90``), at its shapes
     (C = 2^18 rows of 128 f32, N = 16,384 and 110,592 random slots),
     checked against ``table[slots]`` and timed beside ``index_select``?

Every time is ``timing.time_cold``'s: the mean over 20 calls after a
warm-up, each with the 50 MB L2 cache flushed before it, so rows come from
HBM as a cold caller finds them (``chip_smoke.py`` times K6 the same way).
K6's bound counts the bytes of :func:`k6_bytes`, as ``chip_smoke.py``
does. Prints one line per measurement and one JSON line of them all, with
the card's name and power limit. Needs one CUDA device: exits 2 without
one.
"""

import json
import subprocess
import sys

import numpy as np
import torch

from ct_icp_torch.kernels import row_gather as k6
from ct_icp_torch.ops import voxel as vx
from ct_icp_torch.tools import timing

C = 1 << 18


def k6_bytes(table, slots, sub=None) -> int:
    """The bytes ``row_gather(table, slots, sub)`` must move: each distinct
    row it reads, the slots, ``sub``, and every output row written."""
    return k6_fields_bytes((table,), slots, (sub,))


def k6_fields_bytes(tables, slots, subs) -> int:
    """The bytes ``row_gather_fields(tables, slots, subs)`` must move: each
    distinct row of each table it reads, the slots once, each sub and every
    output row written."""
    c = tables[0].shape[0]
    valid = slots[(slots >= 0) & (slots < c)]
    read = torch.unique(valid).numel()
    n = slots.numel()
    total = n * 4
    for table, sub in zip(tables, subs):
        row_b = table.shape[1] * 4
        total += read * row_b + n * row_b
        total += 0 if sub is None else sub.numel() * 4
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_gather: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print("card:", card, flush=True)
    rng = np.random.default_rng(0)
    rows = []

    def record(name, ms, **kw):
        rows.append(dict(name=name, ms=ms, **kw))
        extra = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"{name:40s} {ms:9.4f} ms  {extra}", flush=True)

    def slots_of(n, sort=False):
        s = rng.integers(0, C, n)
        return torch.from_numpy(np.sort(s) if sort else s).to(
            device=dev, dtype=torch.int32)

    # 1-2: the row gather by indexing, over widths, types and row counts
    for width, dtype in [(128, torch.float32), (64, torch.float32),
                         (128, torch.int16), (8, torch.float32),
                         (1, torch.float32)]:
        table = torch.from_numpy(rng.standard_normal((C, width))).to(
            device=dev, dtype=dtype)
        for n in (16384, 32768, 110592):
            slots = slots_of(n).long()
            ms, _ = timing.time_cold(lambda: table[slots])
            by = n * width * table.element_size()
            record(f"gather rows N={n} width={width} {dtype}", ms,
                   mrows_per_s=round(n / ms / 1e3, 1),
                   gb_per_s=round(by / ms / 1e6, 2))
        del table
    table = torch.from_numpy(rng.standard_normal((C, 128))).to(
        device=dev, dtype=torch.float32)
    n = 110592
    ms, _ = timing.time_cold(
        lambda s=slots_of(n, sort=True).long(): table[s])
    record(f"gather rows sorted N={n} width=128", ms)

    # the element gather (the key-probe pattern)
    keys = torch.from_numpy(rng.integers(0, 2 ** 31, C)).to(
        device=dev, dtype=torch.int32)
    for n in (110592, 110592 * 16):
        idx = slots_of(n).long()
        ms, _ = timing.time_cold(lambda: keys[idx])
        record(f"element gather N={n} int32", ms,
               melem_per_s=round(n / ms / 1e3, 1))

    # 3: the compaction of a mask (the port's compact_mask)
    mask = torch.from_numpy(rng.random(110592) < 0.2).to(dev)
    ms, _ = timing.time_cold(lambda: vx.compact_mask(mask, 110592))
    record("compact_mask 110592", ms)

    # the scatter-min (the sampling dedup primitive)
    for n in (16384, 65536, 131072):
        tgt = torch.zeros((C,), dtype=torch.int32, device=dev)
        sl = slots_of(n).long()
        vals = torch.from_numpy(rng.integers(0, 100, n)).to(
            device=dev, dtype=torch.int32)
        ms, _ = timing.time_cold(
            lambda: tgt.scatter_reduce_(0, sl, vals, "amin"))
        record(f"scatter-min N={n} int32", ms,
               mrows_per_s=round(n / ms / 1e3, 1))

    # 4: K6 at the Pallas kernel's shapes, checked against table[slots]
    for n in (16384, 110592):
        slots = slots_of(n)
        got = k6.row_gather(table, slots)
        torch.cuda.synchronize()
        ok = bool(torch.equal(got, table[slots.long()]))
        if not ok:
            raise AssertionError(f"row_gather N={n}: != table[slots]")
        ms, _ = timing.time_cold(lambda: k6.row_gather(table, slots))
        idx = slots.long()
        lib, _ = timing.time_cold(lambda: table.index_select(0, idx))
        by = k6_bytes(table, slots)
        record(f"K6 row_gather N={n} w=128 f32", ms, ok=ok,
               gb_per_s=by / ms / 1e6, bound_ms=timing.bound(by, 0)[0],
               index_select_ms=lib)
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
