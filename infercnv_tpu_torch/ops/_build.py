"""Build and load the port's CUDA kernels.

The sources under ``infercnv_tpu_torch/csrc`` have a plain C interface.  At
first use they are compiled by nvcc for Hopper (``sm_90a``), one nvcc
process per ``.cu`` file, all started together, then linked into
``build/infercnv_tpu_torch/libinfercnv_kernels.so`` at the root of the
checkout and loaded with ctypes.  A SHA-256 of the sources and flags decides
whether an existing library is current.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "infercnv_tpu_torch"
LIB_NAME = "libinfercnv_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math (log2f/exp2f accuracy, no subnormal flush in the median
# keys); -fmad=false keeps a*b+c unfused unless the source asks for fmaf
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
                     "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "ic_error_string": ([_I], ctypes.c_char_p),
    "ic_max_smem_optin": ([_P], _I),
    "ic_smooth_banded": ([_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P], _I),
    "ic_smooth_general": ([_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
                          _I),
    "ic_residual_fused": ([_P, _I, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _I,
                           _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _F, _F,
                           _I, _I, _P, _I, _P, _P, _I, _I, _I, _P], _I),
    "ic_row_median": ([_P, _I, _I, _I, _P, *[_I] * 6, _P], _I),
    "ic_median_center_residual": ([_P, _I, _P, _P, _P, _I, _P, _I, _I,
                                   *[_I] * 6, _P], _I),
    "ic_viterbi": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F, _F, _P],
                   _I),
}

_lock = threading.Lock()
_library = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return path


def sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels if the library is missing or stale; return its
    path.  The compiler's output (registers, shared memory, spills per
    kernel) is kept in ``build.log`` beside the library."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = sources_digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    log, failed = [], []
    for src, _obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(o) for _s, o, _p in jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _library = lib
        return _library


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc:
        msg = library().ic_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def max_smem_optin(device: torch.device) -> int:
    """The shared memory a block may opt in to on a CUDA device, in bytes
    (the limit every row kernel checks itself against)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        check(library().ic_max_smem_optin(ctypes.byref(out)), "max_smem_optin")
    return out.value


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_inputs(name: str, *tensors: torch.Tensor) -> None:
    """A kernel's tensors must share one device and be contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input of shape {tuple(t.shape)} is not contiguous")
