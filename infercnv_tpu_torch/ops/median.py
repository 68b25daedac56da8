"""Exact row medians with numpy semantics, and the median-centred residual
tail.

Counterpart of infercnv_tpu/ops/median.py.  The reference finds the two
middle order statistics by a radix select over the order-preserving uint32
keys of the float32 values and returns ``(lo + hi) * 0.5`` (the mean of the
two middle values for even n, which is also what ``jnp.median`` computes).
Two wrappers launch the CUDA kernels of ``csrc/median.cu``, which run that
select (``csrc/radix_select.cuh``, shared with the fused residual kernel):

* ``row_median`` replaces the TPU kernel ``_median_kernel``
  (``row_median_pallas``, lines 95-106 and 181-223);
* ``median_center_residual`` replaces ``_median_epilogue_kernel``
  (``median_center_residual_pallas``, lines 109-178): the median of each row
  of a smooth output, subtracted, then the stage-2 where-bounds and exp2.

Their plain versions sort the same keys and read off the same order
statistics, so every median here is bit-identical to the reference for every
float32 input, negative zero and infinities included.  ``torch.median`` is
not used: it returns the lower of the two middle values.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from infercnv_tpu_torch.ops import _build

#: launches of each CUDA kernel (the plain versions do not count): the row
#: median (TPU kernel 7) and the median-centred tail (TPU kernel 6)
LAUNCHES = 0
LAUNCHES_EPILOGUE = 0

_SIGN = 0x80000000
_MASK32 = 0xFFFFFFFF


def to_key(v: torch.Tensor) -> torch.Tensor:
    """float32 -> order-preserving uint32 key, held in int64."""
    u = v.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    neg = (u & _SIGN) != 0
    return torch.where(neg, u ^ _MASK32, u | _SIGN)


def from_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_key`: int64 keys -> float32 values."""
    pos = (key & _SIGN) != 0
    u = torch.where(pos, key & 0x7FFFFFFF, key ^ _MASK32)
    u = torch.where(u >= _SIGN, u - (1 << 32), u)  # as signed int32 bits
    return u.to(torch.int32).view(torch.float32)


def row_median_plain(v: torch.Tensor) -> torch.Tensor:
    """Exact median along the last axis of a float32 tensor [..., n]: the
    sort of the order-preserving keys."""
    v = v.to(torch.float32)
    n = v.shape[-1]
    keys, _ = torch.sort(to_key(v), dim=-1)
    k2 = n // 2
    hi = from_key(keys[..., k2])
    if n % 2 == 1:
        return hi
    lo = from_key(keys[..., k2 - 1])
    return (lo + hi) * 0.5


def row_median(v: torch.Tensor) -> torch.Tensor:
    """Exact median along the last axis of a float32 tensor [..., n].  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if v.device.type == "cpu":
        return row_median_plain(v)
    global LAUNCHES
    if v.dtype != torch.float32 or v.dim() == 0 or v.shape[-1] == 0:
        raise ValueError(f"row_median: need f32 [..., n > 0], got {v.dtype} "
                         f"{tuple(v.shape)}")
    n = v.shape[-1]
    x = v.reshape(-1, n).contiguous()
    med = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.ic_row_median(_build.ptr(x), n, x.shape[0], n, _build.ptr(med),
                               _build.stream_of(x))
    _build.check(rc, "row_median")
    LAUNCHES += 1
    return med.reshape(v.shape[:-1])


def median_center_residual_plain(yp: torch.Tensor, gmin: torch.Tensor,
                                 gmax: torch.Tensor, num_genes: int):
    """(residual [C, num_genes], medians [C]) of a smooth output yp [C, Gp]
    whose columns >= num_genes are ignored: y - median, then the where-form
    bounds, then exp2, in the reference's op order
    (infercnv_tpu/ops/median.py:121-126)."""
    y = yp[:, :num_genes].to(torch.float32)
    med = row_median_plain(y)
    r = y - med[:, None]
    out = torch.where(r > gmax, r - gmax, torch.zeros((), device=r.device))
    out = torch.where(r < gmin, r - gmin, out)
    return torch.exp2(out), med


def median_center_residual(yp: torch.Tensor, gmin: torch.Tensor,
                           gmax: torch.Tensor, num_genes: int,
                           with_median: bool = False
                           ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Final residual [C, num_genes] of a smooth output yp [C, Gp]
    (Gp >= num_genes; the columns past num_genes are ignored): each row's
    exact median subtracted, the stage-2 where-bounds gmin/gmax [num_genes]
    applied, exp2.  with_median also returns the row medians [C].  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if yp.device.type == "cpu":
        out, med = median_center_residual_plain(yp, gmin, gmax, num_genes)
        return (out, med) if with_median else out
    global LAUNCHES_EPILOGUE
    if yp.dtype != torch.float32 or yp.dim() != 2 or yp.shape[1] < num_genes \
            or num_genes <= 0:
        raise ValueError(f"median_center_residual: need f32 [C, >= {num_genes}], "
                         f"got {yp.dtype} {tuple(yp.shape)}")
    for b in (gmin, gmax):
        if b.dtype != torch.float32 or tuple(b.shape) != (num_genes,):
            raise ValueError("median_center_residual: bounds must be f32 "
                             f"rows of {num_genes}")
    _build.check_inputs("median_center_residual", yp, gmin, gmax)
    C = yp.shape[0]
    out = torch.empty((C, num_genes), dtype=torch.float32, device=yp.device)
    med = (torch.empty((C,), dtype=torch.float32, device=yp.device)
           if with_median else None)
    lib = _build.library()
    with torch.cuda.device(yp.device):
        rc = lib.ic_median_center_residual(
            _build.ptr(yp), yp.shape[1], _build.ptr(gmin), _build.ptr(gmax),
            _build.ptr(out), num_genes, None if med is None else _build.ptr(med),
            C, num_genes, _build.stream_of(yp))
    _build.check(rc, "median_center_residual")
    LAUNCHES_EPILOGUE += 1
    return (out, med) if with_median else out
