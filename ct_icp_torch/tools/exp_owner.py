"""K11 ``owner_pack`` of another tree (the parent) and of this tree on the
same chunks in one process, on the card.

    python -m ct_icp_torch.tools.exp_owner <other tree>

``<other tree>`` is a checkout holding a ``ct_icp_torch`` package (e.g. a
``git archive`` of the parent commit into a directory ``.gitignore``
lists, such as ``build/parent``). Its ``csrc/owner_pack.cu`` is built
into a library of its own (this tree's flags, ``-Xptxas -v``) and its
wrapper, ``kernels/owner_pack.py``, runs as it is, its launcher lookups
answered from that library: the other tree's host side as well as its
kernels. This tree's kernel is built afresh.

The chunks: the partitioned insert's second call at world size 1 (the
driving corridor's frame 1 through ``DistributedOdometry(
default_driving_profile(), map_update="partitioned")``, as
``chip_smoke.py`` phase 21 takes it: m = 65,536, n = 1, cap = 131,072) and
its first half at two ranks' shapes (m = 32,768, n = 2, the pair capacity
of ``sharded_map.pair_capacity``).

For each chunk and each of the two trees: the outputs against the plain
version bit for bit (two calls in a row), a SHA-256 of them (equal across
both, or the script exits 1), and the time on the device with the L2
flushed before each call (``timing.time_cold``), back to back in a CUDA
graph of 20 (``timing.time_stateless``), with the host side
(``timing.time_host``: events around the call, the device idle before
it) and the host's enqueue alone (400 calls back to back on the host's
clock), in the order other, this, this, other;
beside the bound (bytes) and the yardstick ``torch.sort(owner, stable=
True)`` on the chunk's prebuilt int32 owners (invalid points last): the
grouping alone, without the scatter, which the port never calls. Prints
one JSON line a chunk and a summary with the card's name and power limit,
each build's registers and spills, and this kernel's resident blocks with
the most points one call takes at n = 1, 2 and 64. Needs one CUDA
device.
"""

import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import owner_pack as k11
from ct_icp_torch.tools.exp_ct_ba import card_line
from ct_icp_torch.tools.timing import (bound, time_cold, time_host,
                                       time_stateless)

def _ptxas(text: str):
    return [x.strip() for x in text.splitlines()
            if re.search("registers|spill|Compiling", x)]


def other_tree(root: Path):
    """The other tree's owner_pack wrapper module, its launcher lookups
    answered from its own kernel built here, and that build's ptxas
    lines."""
    src = root / "ct_icp_torch" / "csrc" / "owner_pack.cu"
    lib = build.BUILD_DIR / "exp_owner_other.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run(
        [build.nvcc_path(), *build._flags(), "-I", str(src.parent), "-o",
         str(lib), str(src)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"{src}: {out.stderr[-3000:]}")
    cdll = ctypes.CDLL(str(lib))
    cache = {}

    def launcher(name, symbol, argtypes, defines=()):
        fn = cache.get((name, symbol, tuple(defines)))
        if fn is None:
            fn = getattr(cdll, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            cache[(name, symbol, tuple(defines))] = fn
        return fn

    shim = types.SimpleNamespace(**{k: getattr(build, k) for k in dir(build)
                                    if not k.startswith("__")})
    shim.launcher = launcher
    mod = types.ModuleType("owner_pack_other")
    path = root / "ct_icp_torch" / "kernels" / "owner_pack.py"
    exec(compile(path.read_text(), str(path), "exec"), mod.__dict__)
    mod.build = shim
    return mod, _ptxas(out.stderr)


def chunks(dev):
    """The partitioned insert's second call at world size 1 and its first
    half at two ranks' shapes: [(tag, world, valid, res, n, cap)]."""
    from ct_icp_torch.config.options import default_driving_profile
    from ct_icp_torch.datasets import corridor as cor
    from ct_icp_torch.parallel import sharded_map as shm
    from ct_icp_torch.parallel.distributed_odometry import \
        DistributedOdometry
    frames = cor.render_corridor(
        cor.build_scene(), cor.straight_trajectory(400, 80 * 0.1 + 0.5), 2,
        cor.APE_SEEDS[0])
    seen, pack = [], k11.owner_pack

    def spy(world, valid, res, n, cap):
        seen.append((world.clone(), valid.clone(), res, n, cap))
        return pack(world, valid, res, n, cap)

    k11.owner_pack = spy
    try:
        odo = DistributedOdometry(default_driving_profile(), device=dev,
                                  map_update="partitioned")
        for fr in frames:
            odo.register_frame(fr["xyz"], fr["timestamps"])
    finally:
        k11.owner_pack = pack
    world, valid, res, n, cap = seen[1]
    m2 = (world.shape[0] + 1) // 2
    return [("world size 1", world, valid, res, n, cap),
            ("2 ranks", world[:m2].contiguous(), valid[:m2].contiguous(),
             res, 2, shm.pair_capacity(m2, 2, 2.0))]


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.reshape(-1).contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def enqueue_ms(fn, reps=400) -> float:
    """Host ms a call of ``fn()`` called back to back: the wrapper's checks,
    allocations and launch, where the device keeps up (one synchronize at
    the end of the run)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def times(fn) -> dict:
    cold, _ = time_cold(fn)
    warm, _ = time_stateless(fn)
    host, _ = time_host(fn, reps=200)
    return {"ms": cold, "warm_ms": warm, "host_ms": host,
            "enqueue_ms": enqueue_ms(fn)}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__.splitlines()[3].strip(), file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("exp_owner: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    other, other_regs = other_tree(Path(args[0]).resolve())
    build._lib_path("owner_pack").unlink(missing_ok=True)
    build.build_all(["owner_pack"])
    regs = {"other": other_regs,
            "this": _ptxas(build.build_info["owner_pack"]["ptxas"])}
    resident = k11.resident_blocks()
    limits = {"resident_blocks": resident,
              "most_points": {n: resident * min(k11.MAX_TILES, k11.MAX_CELLS
                                                // (n * k11.WARPS))
                              * k11.THREADS for n in (1, 2, 64)}}
    summary, same = {}, True
    for tag, world, valid, res, n, cap in chunks(dev):
        call = (world, valid, res, n, cap)
        fns = {"other": lambda: other.owner_pack(*call),
               "this": lambda: k11.owner_pack(*call)}
        want = k11.owner_pack_plain(*call)
        rec = {"shape": f"m={world.shape[0]} valid={int(valid.sum())} "
                        f"n={n} cap={cap} sent={int(want.send_valid.sum())} "
                        f"dropped={int(want.dropped[0])}",
               "plain_digest": digest(want)}
        for name, fn in fns.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            ok = all(torch.equal(a, b) and torch.equal(a, c)
                     for a, b, c in zip(got, again, want))
            rec[name] = {"bit_for_bit": ok, "digest": digest(got),
                         "runs": []}
            same &= ok and rec[name]["digest"] == rec["plain_digest"]
        for name in ("other", "this", "this", "other"):
            rec[name]["runs"].append(times(fns[name]))
        m = world.shape[0]
        rec["bound_ms"], rec["bound_by"] = bound(m * 13 + n * cap * 13 + 4,
                                                 0.0)
        owner = torch.where(valid, k11.owners(world, res, n),
                            torch.full((m,), n, device=dev)).to(torch.int32)
        rec["sort_yardstick"] = times(lambda: torch.sort(owner, stable=True))
        print(json.dumps({tag: rec}), flush=True)
        summary[tag] = rec
    print(json.dumps({"card": card_line(), "same_digests": same,
                      "registers": regs, "limits": limits,
                      "summary": {t: {k: (v["runs"] if isinstance(v, dict)
                                          and "runs" in v else v)
                                      for k, v in r.items()}
                                  for t, r in summary.items()}}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
