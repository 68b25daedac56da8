"""Exact row median with numpy semantics, in plain PyTorch.

Counterpart of infercnv_tpu/ops/median.py::row_median (lines 42-69).  The
reference finds the two middle order statistics by a radix select over the
order-preserving uint32 keys of the float32 values and returns
``(lo + hi) * 0.5`` (the mean of the two middle values for even n, which is
also what ``jnp.median`` computes).  Here the same keys are sorted and the
same order statistics read off, so the result is bit-identical to the
reference for every float32 input, negative zero and infinities included.

``torch.median`` is not used: it returns the lower of the two middle values.
The fused residual kernel (ops/residual_fused.py) carries its own radix
select on the card.
"""

from __future__ import annotations

import torch

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


def row_median(v: torch.Tensor) -> torch.Tensor:
    """Exact median along the last axis of a float32 tensor [..., n]."""
    v = v.to(torch.float32)
    n = v.shape[-1]
    keys, _ = torch.sort(to_key(v), dim=-1)
    k2 = n // 2
    hi = from_key(keys[..., k2])
    if n % 2 == 1:
        return hi
    lo = from_key(keys[..., k2 - 1])
    return (lo + hi) * 0.5
