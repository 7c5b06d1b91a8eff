"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is a standalone translation unit with a plain C interface: nvcc
compiles it into ``build/ct_icp_torch/lib<name>-<hash>.so`` (the hash covers
the source and the flags, so an edited kernel never loads a stale library)
and ``ctypes`` loads it. Pointers and the CUDA stream cross as
``c_void_p``. Nothing here runs at import time: the CPU tests import every
module, and this machine may have no ``nvcc``.

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


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    common = (CSRC / "common.cuh").read_bytes()
    digest = hashlib.sha256(src + common + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names) -> None:
    """Compile every missing library of ``names``, one nvcc per source, all
    started together. Raises with the compiler output on any failure."""
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    t0 = time.time()
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"--- {name} ---\n{log}")
            continue
        os.replace(tmp, out)
        build_info[name] = {"seconds": time.time() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


# argument types of the launchers' C signatures
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def launcher(name: str, symbol: str, argtypes):
    """The C launcher ``symbol`` of ``csrc/<name>.cu`` (built first if
    needed), with its argument types declared; it returns the
    ``cudaGetLastError()`` after its launches."""
    key = (name, symbol)
    fn = _loaded.get(key)
    if fn is None:
        build_all([name])
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
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
