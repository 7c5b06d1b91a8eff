"""ctypes bridge to the native IO library (``native/slamio.cc``): the PLY
vertex decoder and the NCLT ``velodyne_hits.bin`` stream (counterpart of
``ct_icp_tpu/io/native.py``).

The library is compiled from the source at first use, with the flags of
``native/Makefile``, into ``build/ct_icp_torch/libslamio-<hash>.so`` (the
hash covers the source, the compiler and the flags, as ``kernels/build.py``
does for the CUDA kernels). The ``.so`` files committed under ``native/``
are never loaded: they were built for another machine's instruction set.
When no compiler is at hand every entry point falls back to the
pure-Python readers (``io/ply.py``, ``datasets/dataset.py``), as the
reference does: this is host IO, not the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "slamio.cc"
BUILD_DIR = _ROOT / "build" / "ct_icp_torch"
# native/Makefile's CXXFLAGS. -ffp-contract=off keeps the u16 -> metres
# decode (v * 0.005 - 100.0) a plain multiply and subtract: an FMA rounds
# differently and parts from the pure-Python decode in the last ulp
CXXFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
            "-fPIC", "-Wall", "-shared")

_lib = None
_tried = False


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def lib_path() -> Path:
    """Where the library of this source, compiler and flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        (_compiler(),) + CXXFLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libslamio-{digest}.so"


def _build(path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([_compiler(), *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)      # atomic: a concurrent reader sees all or none
    return True


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not SOURCE.exists():
        return None
    path = lib_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.ply_read_xyzt.restype = ctypes.c_long
    lib.ply_read_xyzt.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int)]
    lib.nclt_open.restype = ctypes.c_void_p
    lib.nclt_open.argtypes = [ctypes.c_char_p]
    lib.nclt_close.argtypes = [ctypes.c_void_p]
    lib.nclt_read.restype = ctypes.c_long
    lib.nclt_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def ply_read_xyzt(path, cap: int = 1 << 21
                  ) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Native PLY vertex decode; None -> the caller uses the Python path."""
    lib = _load()
    if lib is None:
        return None
    xyz = np.empty((cap, 3), np.float64)
    ts = np.empty((cap,), np.float64)
    has_time = ctypes.c_int(0)
    n = lib.ply_read_xyzt(
        str(path).encode(), xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap,
        ctypes.byref(has_time))
    if n < 0:
        return None  # a flavour it does not decode (ascii, lists)
    return xyz[:n].copy(), (ts[:n].copy() if has_time.value else None)


class NcltNativeReader:
    """Streaming native decoder of velodyne_hits.bin."""

    def __init__(self, path):
        lib = _load()
        if lib is None:
            raise RuntimeError("native slamio unavailable")
        self._lib = lib
        self._h = lib.nclt_open(str(path).encode())
        if not self._h:
            raise FileNotFoundError(path)

    def read(self, num_batches: int, skip: bool = False, cap: int = 1 << 21):
        xyz = np.empty((cap, 3), np.float64)
        ts = np.empty((cap,), np.float64)
        n = self._lib.nclt_read(
            self._h, num_batches, 1 if skip else 0,
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap)
        if n == -2:
            raise ValueError("The batch does not have a matching magic number")
        if n < 0:
            return None
        return xyz[:n].copy(), ts[:n].copy()

    def close(self):
        if self._h:
            self._lib.nclt_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
