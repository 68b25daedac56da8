"""Row passes of ``CnvEngine.ref_stats``' one-shot form.

Counterpart of the first and last passes of infercnv_tpu/parallel/engine.py
``_ref_stats``, which XLA fuses on the TPU; no TPU kernel is replaced.  Two
wrappers launch the CUDA kernels of ``csrc/ref_stats.cu``:

* ``log_norm``: the log-normalised counts ``log2(c / rowsum * nf + 1)``,
  rounded as the reference's ops round (the first ops of
  ``residual_fused``);
* ``noise_rows``: each row's sum and correction-1 standard deviation of the
  reference residual ``exp2(where_bounds(x, lo, hi))`` before denoising,
  from which the engine takes the pooled denoise bounds.

The middle pass, kernel 1's front, is ``residual_fused.ref_centred``.  The
plain versions are the engine's former PyTorch ops.
"""

from __future__ import annotations

import torch

from infercnv_tpu_torch.ops import _build
from infercnv_tpu_torch.ops.residual_fused import (
    _IN_CODES,
    counts_to_f32,
    where_bounds,
)

#: launches of each CUDA kernel (the plain versions do not count)
LAUNCHES_LOG_NORM = 0
LAUNCHES_NOISE_ROWS = 0


def log_norm_plain(counts: torch.Tensor, norm_factor: float) -> torch.Tensor:
    c = counts_to_f32(counts)
    cs = c.sum(dim=1, keepdim=True)
    return torch.log2(c / cs * norm_factor + 1.0)


def log_norm(counts: torch.Tensor, norm_factor: float) -> torch.Tensor:
    """counts [C, G] (f32, u16, i16, i32 or u32) -> log2(c / rowsum *
    norm_factor + 1) [C, G] f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if counts.device.type == "cpu":
        return log_norm_plain(counts, norm_factor)
    global LAUNCHES_LOG_NORM
    if counts.dtype not in _IN_CODES or counts.dim() != 2:
        raise ValueError(f"log_norm: need [C, G] counts in {list(_IN_CODES)}, "
                         f"got {counts.dtype} {tuple(counts.shape)}")
    _build.check_inputs("log_norm", counts)
    out = torch.empty(counts.shape, dtype=torch.float32, device=counts.device)
    with torch.cuda.device(counts.device):
        rc = _build.library().ic_log_norm(
            _build.ptr(counts), _IN_CODES[counts.dtype], float(norm_factor),
            counts.shape[0], counts.shape[1], _build.ptr(out),
            _build.stream_of(counts))
    _build.check(rc, "log_norm")
    LAUNCHES_LOG_NORM += 1
    return out


def noise_rows_plain(x: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    final = torch.exp2(where_bounds(x, lo, hi))
    return torch.stack([final.sum(dim=1), final.std(dim=1, correction=1)], dim=1)


def noise_rows(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """x [C, G] f32, lo and hi [G] f32 -> [C, 2] f32: each row's sum and
    correction-1 standard deviation of exp2(where_bounds(x, lo, hi)).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (G >= 2)."""
    if x.device.type == "cpu":
        return noise_rows_plain(x, lo, hi)
    global LAUNCHES_NOISE_ROWS
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] < 2:
        raise ValueError(f"noise_rows: need f32 [C, G >= 2], got {x.dtype} "
                         f"{tuple(x.shape)}")
    G = x.shape[1]
    lo, hi = lo.reshape(-1), hi.reshape(-1)
    for b in (lo, hi):
        if b.dtype != torch.float32 or b.shape[0] != G:
            raise ValueError("noise_rows: bounds must be f32 rows of G")
    _build.check_inputs("noise_rows", x, lo, hi)
    out = torch.empty((x.shape[0], 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().ic_noise_rows(
            _build.ptr(x), _build.ptr(lo), _build.ptr(hi), x.shape[0], G,
            _build.ptr(out), _build.stream_of(x))
    _build.check(rc, "noise_rows")
    LAUNCHES_NOISE_ROWS += 1
    return out
