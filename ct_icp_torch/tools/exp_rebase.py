"""The cost law of the map rebase's two kernels on the card: K7
``rebuild_claim`` (one cooperative launch) and K6 ``row_gather`` over the
rebase's four fields (one launch).

    python -m ct_icp_torch.tools.exp_rebase

Two levels of the sizes the paths rebase (the long drive's: C = 2^18,
P = 30, 0.8 m voxels; the robust run's: C = 2^19, P = 40, 0.5 m), filled
by the insert kernel with random points over a 240 m x 40 m x 7 m street
(seed 0), shifted by a long-drive rebase's shift. Questions:
  1. what sets K7's time: the call cut after each phase (a variant built
     with -DK7_PHASES=1..4: the clear, + derive, + claim rounds, +
     election), and the block size and blocks an SM (-DK7_THREADS,
     -DK7_BLOCKS_PER_SM; the main build: 1,024 threads, 2 blocks an SM);
  2. K6's one launch over the four fields by its tile (-DK6_TILE output
     elements; the main build 4,096) and chunks in flight a thread
     (-DK6_UNROLL; 2), beside the points alone, the three narrow fields
     alone and a memset of the same output bytes (``zero_``), the floor of
     a pass that writes them;
  3. the whole ``rebuild_level``;
  4. K6's variants on one table at the Pallas kernel's shape (2^18 x 128
     float32, 110,592 random slots: no empty row).
Every variant is checked bit for bit against the plain version first.
Times are ``timing.time_cold``'s (L2 flushed before each call). Prints one
line per measurement and one JSON line of them all, with the card's name
and power limit. Needs one CUDA device: exits 2 without one.
"""

import json
import subprocess
import sys

import numpy as np
import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import rebuild as k7
from ct_icp_torch.kernels import row_gather as k6
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.tools import timing
from ct_icp_torch.tools.exp_gather import k6_fields_bytes

LEVELS = ((18, 30, 0.8, 60000, "long drive size"),
          (19, 40, 0.5, 45000, "robust size"))
SHIFT = (100.12103, -0.158931, -4.6e-06)
K7_VARIANTS = (("K7_PHASES=1",), ("K7_PHASES=2",), ("K7_PHASES=3",),
               ("K7_PHASES=4",), (), ("K7_BLOCKS_PER_SM=1",),
               ("K7_THREADS=512",), ("K7_THREADS=256",),
               ("K7_THREADS=256", "K7_BLOCKS_PER_SM=4"),
               ("K7_THREADS=256", "K7_BLOCKS_PER_SM=8"))
K6_VARIANTS = ((), ("K6_TILE=2048",), ("K6_TILE=8192",), ("K6_TILE=16384",),
               ("K6_UNROLL=4",), ("K6_UNROLL=8",))


def street_level(dev, cap_log2, p, res, n, seed=0):
    rng = np.random.default_rng(seed)
    level = vm.make_level(cap_log2, p, dev)
    pts = np.stack([rng.uniform(0, 240, n), rng.uniform(-20, 20, n),
                    rng.uniform(-1, 6, n)], -1).astype(np.float32)
    t = torch.from_numpy(pts).to(dev)
    vm.insert_points(level, t, torch.ones(n, dtype=torch.bool, device=dev),
                     res, 0.1, 12)
    level.normals.copy_(torch.from_numpy(
        rng.standard_normal((level.capacity, 3)).astype(np.float32)))
    level.nflags.copy_(torch.from_numpy(
        rng.integers(0, 4, level.capacity).astype(np.int32)))
    return level


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_rebase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print("card:", card, flush=True)
    build.build_all(["rebuild_claim", "row_gather"])
    for d in K7_VARIANTS:
        build.build_all(["rebuild_claim"], d)
    for d in K6_VARIANTS:
        build.build_all(["row_gather"], d)
    rows = []

    def record(name, ms, **kw):
        rows.append(dict(name=name, ms=ms, **kw))
        extra = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"{name:58s} {ms:9.4f} ms  {extra}", flush=True)

    for cap_log2, p, res, n, tag in LEVELS:
        level = street_level(dev, cap_log2, p, res, n)
        shift = torch.tensor(SHIFT, dtype=torch.float32, device=dev)
        kargs = (level.keys, level.count, level.points, shift, res)
        want = k7.rebuild_claim_plain(*kargs)
        occupied = int(((level.keys != 0) & (level.keys != 1)
                        & (level.count > 0)).sum())
        print(f"{tag}: C=2^{cap_log2} P={p} occupied={occupied} rows kept "
              f"{int((want[1] >= 0).sum())}", flush=True)
        for d in K7_VARIANTS:
            counter = k7.rounds_counter(dev)
            before = int(counter[0])
            got = k7.launch(*kargs, defines=d)
            torch.cuda.synchronize()
            ran = int(counter[0]) - before
            if "K7_PHASES" not in " ".join(d):
                for a, b in zip(got, want):
                    if not torch.equal(a, b):
                        raise AssertionError(f"K7 {d} != plain")
            ms, _ = timing.time_cold(lambda: k7.launch(*kargs, defines=d))
            record(f"K7 {tag} {' '.join(d) or 'main build'}", ms,
                   rounds=ran)
        src = want[1]
        tables = (level.count[:, None], level.points, level.normals,
                  level.nflags[:, None])
        subs = (None, shift, None, None)
        plain = k6.row_gather_fields_plain(tables, src, subs)
        b_ms = timing.bound(k6_fields_bytes(tables, src, subs), 0)[0]
        for d in K6_VARIANTS:
            got = k6.launch(tables, src, subs, defines=d)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                raise AssertionError(f"K6 {d} != plain")
            ms, _ = timing.time_cold(lambda: k6.launch(tables, src, subs,
                                                       defines=d))
            pts_ms, _ = timing.time_cold(lambda: k6.launch(
                tables[1:2], src, subs[1:2], defines=d))
            narrow_ms, _ = timing.time_cold(lambda: k6.launch(
                (tables[0], tables[2], tables[3]), src, (None,) * 3,
                defines=d))
            record(f"K6 four fields {tag} {' '.join(d) or 'main build'}", ms,
                   bound_ms=b_ms, points_alone_ms=pts_ms,
                   narrow_fields_ms=narrow_ms)
        outs = [torch.empty_like(o) for o in plain]
        ms, _ = timing.time_cold(lambda: [o.zero_() for o in outs])
        record(f"memset of the four outputs {tag}", ms,
               bytes=sum(o.numel() * 4 for o in outs))
        big = torch.empty(sum(o.numel() for o in outs), dtype=torch.int32,
                          device=dev)
        ms, _ = timing.time_cold(big.zero_)
        record(f"memset of one buffer of their bytes {tag}", ms)
        ms, _ = timing.time_cold(lambda: vm.rebuild_level(level, shift, res))
        record(f"rebuild_level {tag}", ms)
        del level, outs, big, plain
        torch.cuda.empty_cache()
    # K6 on one table at the Pallas dma_gather_kernel's shape (every slot a
    # row: the variants' cost where no row is empty)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal(
        (1 << 18, 128)).astype(np.float32)).to(dev)
    slots = torch.from_numpy(rng.integers(0, 1 << 18, 110592).astype(
        np.int32)).to(dev)
    for d in K6_VARIANTS:
        (got,) = k6.launch((table,), slots, defines=d)
        if not torch.equal(got, table[slots.long()]):
            raise AssertionError(f"K6 {d} != table[slots]")
        ms, _ = timing.time_cold(lambda: k6.launch((table,), slots,
                                                   defines=d))
        record(f"K6 one table N=110592 W=128 {' '.join(d) or 'main build'}",
               ms)
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
