"""Build and load the port's CUDA kernels (csrc/*.cu): all of them when an
entry point first resolves a CUDA device (:func:`prepare`), any one at its
first use.

Each source is a standalone translation unit with a plain C interface: nvcc
compiles it into ``build/ct_icp_torch/lib<name>-<hash>.so`` (the hash covers
the source, the shared headers and the flags, so an edited kernel never
loads a stale library) and ``ctypes`` loads it. A source of :data:`PARTS`
is compiled into one library a part, each with its part's define.
Pointers and the CUDA stream cross as ``c_void_p``. Nothing here runs at
import time: the CPU tests import every module, and a machine without a
card may have no ``nvcc``.

Flags: ``-fmad=false`` because integer outputs (voxel ids, in-radius counts,
histogram bins, min-distance accepts) come from float compares, and an FMA
contraction would move them off the plain PyTorch version at the last ulp;
no ``--use_fast_math``, so ``x / v`` stays an IEEE division.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "ct_icp_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

# the sources built as several libraries, one a define: K5's instances, a
# library a residual family (Family in kernels/lm_step.py), so that its
# build, the longest, runs on several cores
PARTS = {"lm_step": tuple(f"K5_FAMILY={f}" for f in range(5))}
# the sources whose build is the longest; build_all runs every other nvcc
# at a lower priority, so that these keep a core while they all build
# together
LONGEST_BUILDS = ("lm_step",)

_loaded = {}
# per-source build record: {"seconds": float, "ptxas": str} of the last build
# this process ran (empty when the library was already on disk)
build_info = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _flags(defines=()):
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _lib_path(name: str, defines=()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def kernel_names():
    """The name of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def libraries(name, defines=()):
    """(name, defines) of each library of source ``name`` with ``defines``:
    one, or one a part of :data:`PARTS`."""
    return [(name, tuple(defines) + part)
            for part in ([(p,) for p in PARTS[name]] if name in PARTS
                         else [()])]


def build_all(names, defines=()) -> None:
    """Compile every missing library of ``names`` (:func:`libraries`), one
    nvcc per library, all started together; ``defines`` (``"NAME"`` or
    ``"NAME=value"``) build a variant of each, which the main path never
    loads. Raises with the compiler output on any failure."""
    _build([lib for n in names for lib in libraries(n, defines)],
           variant=bool(defines))


def _build(libs, variant):
    """Compile the missing ones of ``libs``, (name, defines) pairs."""
    todo = [(n, d, _lib_path(n, d)) for n, d in libs
            if not _lib_path(n, d).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    t0 = time.time()
    for name, defines, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        lower = None if name in LONGEST_BUILDS and not variant \
            else _lower_priority
        procs.append((name, defines, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            preexec_fn=lower)))
    failed = []
    for name, defines, out, tmp, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"--- {name} {' '.join(defines)} ---\n{log}")
            continue
        os.replace(tmp, out)
        build_info[" ".join((name,) + defines)] = {
            "seconds": time.time() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _lower_priority():
    """Runs in a child nvcc before it starts: its own scheduling priority
    lowered (``LONGEST_BUILDS``)."""
    os.nice(10)


_prepared = []


def prepare() -> None:
    """Build every kernel source, once per process (a no-op for libraries
    already on disk). Entry points call it when they resolve a CUDA device,
    so that no kernel's build lands inside a run: built at first use, the
    first rebase would stall a drive for the seconds of K6's and K7's
    build."""
    if not _prepared:
        build_all(kernel_names())
        _prepared.append(True)


# argument types of the launchers' C signatures
PTR, INT, LONG, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)


def launcher(name: str, symbol: str, argtypes, defines=()):
    """The C launcher ``symbol`` of ``csrc/<name>.cu`` (of its library built
    with ``defines``, a part's define among them for a source of
    :data:`PARTS`; built first if needed), with its argument types
    declared; it returns the ``cudaGetLastError()`` after its launches."""
    key = (name, symbol, tuple(defines))
    fn = _loaded.get(key)
    if fn is None:
        _build([(name, tuple(defines))],
               variant=any(d not in PARTS.get(name, ()) for d in defines))
        fn = getattr(ctypes.CDLL(str(_lib_path(name, defines))), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[key] = fn
    return fn


def check_status(status: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {status})")


def check_tensor(t, dtype, shape, kernel: str, name: str, device) -> None:
    """A kernel argument must be a contiguous ``dtype`` tensor of ``shape``
    on ``device`` (a CUDA device)."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must be {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def ptr(t):
    return t.data_ptr()


def stream_of(t):
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
