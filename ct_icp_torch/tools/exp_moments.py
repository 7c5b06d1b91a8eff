"""K2's cost law on the card: the time of one ``plane_moments`` call by the
lanes per query (G) and the live points per query.

    python3 -m ct_icp_torch.tools.exp_moments [--queries 2850]

A synthetic problem at the robust profile's widths: a table of 2^16 rows of
P = 40 points (N(0, 0.35) m around the origin), M queries near the origin
(N(0, 0.1) m), O' = 48 candidate slots a query drawn at random, and L live
points a query spread over the candidates in full rows of 40 (the last one
partial). For each G (the main path's build, G = 32, and the variants
built with ``-DK2_GROUP=8`` and ``-DK2_GROUP=16``) and each L, the device time
of a fresh call (the 32-shell radius computed, two passes over the live
points) and of a call with a cached radius (one pass), each a CUDA graph of
20 calls (``tools/timing.py``), beside the bound of the same work: the
distinct live map points read once, the slot pairs, the queries and the
outputs. Radius 0.8 m, k_nearest 20. Prints one JSON line per (G, L) and
the card's line.
"""

import argparse
import json
import subprocess

import numpy as np
import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import plane_moments as k2
from ct_icp_torch.tools.timing import bound, time_stateless

P = 40
ROWS = 1 << 16
CANDIDATES = 48
RADIUS = 0.8
K_NEAREST = 20
LIVE = (0, 20, 81, 160, 480, 960, 1920)
# the kernel's builds: the main path's (G = 32), and the measurement variants
GROUPS = {8: ("K2_GROUP=8",), 16: ("K2_GROUP=16",), 32: ()}


def problem(rng, m, live, dev):
    """(points, slots, cnt_ok, queries) with ``live`` live points a query."""
    points = torch.from_numpy(rng.normal(scale=0.35, size=(ROWS, 3 * P))
                              .astype(np.float32)).to(dev)
    slots = torch.from_numpy(rng.integers(0, ROWS, (m, CANDIDATES))
                             .astype(np.int32)).to(dev)
    # candidate o of a query takes the rank[o]-th row of 40 of its live
    rank = torch.from_numpy(np.argsort(rng.uniform(size=(m, CANDIDATES)),
                                       axis=1)).to(dev)
    cnt = torch.clamp(live - P * rank, 0, P).to(torch.int32)
    queries = torch.from_numpy(rng.normal(scale=0.1, size=(m, 3))
                               .astype(np.float32)).to(dev)
    return points, slots, cnt, queries


def live_work(points, slots, cnt):
    """(distinct live map points, distinct rows holding one, live
    candidates counted per query): what K2 reads once, and its work counted
    per query (the earlier design's byte count). ``chip_smoke.py`` bounds K2
    by the same count."""
    live = cnt > 0
    per_slot = torch.zeros(points.shape[0], dtype=torch.int64,
                           device=points.device)
    per_slot.scatter_reduce_(0, slots[live].long(), cnt[live].long(), "amax")
    return (int(per_slot.sum()), int((per_slot > 0).sum()),
            int(cnt.sum(dtype=torch.int64)))


def k2_bytes(points, slots, cnt):
    """Each distinct live map point once (12 B), the (slot, cnt_ok) pairs,
    the queries and the outputs (100 B a query)."""
    return (live_work(points, slots, cnt)[0] * 12.0 + slots.numel() * 8
            + slots.shape[0] * 100)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=2850)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_moments: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    build.prepare()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    for defines in GROUPS.values():
        build.build_all(["plane_moments"], defines)
    for g, defines in GROUPS.items():
        built = build.launcher("plane_moments", "k2_group", (), defines)()
        if built != g:
            raise RuntimeError(f"the K2_GROUP={g} build reports G = {built}")
    rng = np.random.default_rng(0)
    for live in LIVE:
        pts, slots, cnt, q = problem(rng, args.queries, live, dev)
        want = k2.plane_moments_plain(pts, slots, cnt, q, RADIUS, K_NEAREST)
        n_bytes = k2_bytes(pts, slots, cnt)
        ops = float(cnt.sum()) * 16 + float(want.count.sum()) * 15
        b_ms, b_by = bound(n_bytes, ops)
        for g, defines in GROUPS.items():
            got = k2.launch(pts, slots, cnt, q, RADIUS, K_NEAREST,
                            defines=defines)
            if not (torch.equal(got.count, want.count)
                    and torch.equal(got.r_eff2, want.r_eff2)
                    and torch.equal(got.closest, want.closest)):
                raise RuntimeError(f"G={g} L={live}: counts, radii or "
                                   "closest points differ from plain")
            fresh, _ = time_stateless(lambda: k2.launch(
                pts, slots, cnt, q, RADIUS, K_NEAREST, defines=defines))
            cached, _ = time_stateless(lambda: k2.launch(
                pts, slots, cnt, q, RADIUS, K_NEAREST, want.r_eff2,
                defines=defines))
            print(json.dumps({
                "G": g, "live_per_query": live, "M": args.queries,
                "fresh_ms": fresh, "cached_ms": cached, "bound_ms": b_ms,
                "bound_by": b_by, "fresh_share_of_bound": b_ms / fresh,
                "bytes": n_bytes}), flush=True)
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()
