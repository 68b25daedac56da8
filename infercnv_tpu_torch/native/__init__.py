"""The native (C++) Leiden, built with g++ at first use and loaded with ctypes.

``leiden.cpp`` is infercnv_tpu/native/leiden.cpp, copied unchanged; this
module is the counterpart of infercnv_tpu/native/__init__.py (lines 1-89)
with three differences: the library goes to
``build/infercnv_tpu_torch/libleiden.so`` at the root of the checkout rather
than beside the source; a SHA-256 of the source and the compiler flags
decides whether an existing library is current (as ops/_build.py does for
the CUDA kernels); and a failed build or load raises instead of returning
None, so no caller falls back to a slower partition without saying so.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "leiden.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "infercnv_tpu_torch"
LIB_NAME = "libleiden.so"
#: the reference's flags (infercnv_tpu/native/__init__.py:26), so both
#: libraries compute the same partitions
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def source_digest() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile leiden.cpp with g++ if the library is missing or stale;
    return its path.  Raises RuntimeError naming g++ when it cannot."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "libleiden.sha256"
    digest = source_digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the native Leiden with g++ failed: {e}") from e
    if res.returncode:
        raise RuntimeError(f"building the native Leiden with g++ failed "
                           f"(exit {res.returncode}):\n{res.stdout}")
    os.replace(tmp, lib)
    stamp_tmp = BUILD_DIR / f"libleiden.sha256.{os.getpid()}.tmp"
    stamp_tmp.write_text(digest)
    os.replace(stamp_tmp, stamp)
    return lib


def get_leiden_lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading {path} (built with g++) failed: {e}") from e
            lib.leiden_partition.restype = ctypes.c_int
            lib.leiden_partition.argtypes = [
                ctypes.POINTER(ctypes.c_int64),   # indptr
                ctypes.POINTER(ctypes.c_int32),   # indices
                ctypes.POINTER(ctypes.c_double),  # data
                ctypes.c_int32,                   # n
                ctypes.c_int32,                   # use_cpm
                ctypes.c_double,                  # resolution
                ctypes.c_uint64,                  # seed
                ctypes.c_int32,                   # max_levels
                ctypes.POINTER(ctypes.c_int32),   # membership_out
            ]
            _lib = lib
        return _lib


def leiden_native(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                  n: int, objective: str, resolution: float, seed: int,
                  max_levels: int = 10) -> np.ndarray:
    """Run the C++ Leiden on a CSR graph; returns int64 membership [n]."""
    lib = get_leiden_lib()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    out = np.zeros(n, np.int32)
    rc = lib.leiden_partition(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        np.int32(n), np.int32(1 if objective == "CPM" else 0),
        float(resolution), np.uint64(seed if seed else 1), np.int32(max_levels),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"leiden_partition returned {rc} on a graph of {n} nodes")
    return out.astype(np.int64)
