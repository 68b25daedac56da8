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

``median_plan`` plans their launch on the host from the row width and the
card: persistent blocks that stage rows in shared memory, one row buffer a
block holding as much of the row as fits, the rest read from device memory
on each pass.

Their plain versions sort the same keys and read off the same order
statistics, so every median here is bit-identical to the reference for every
float32 input, negative zero and infinities included.  ``torch.median`` is
not used: it returns the lower of the two middle values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from infercnv_tpu_torch.ops import _build

#: launches of each CUDA kernel (the plain versions do not count): the row
#: median (TPU kernel 7) and the median-centred tail (TPU kernel 6)
LAUNCHES = 0
LAUNCHES_EPILOGUE = 0

_SIGN = 0x80000000
_MASK32 = 0xFFFFFFFF

#: shared memory of a block before its row buffer (kHeadBytes of
#: csrc/median.cu): the select (SelectSmem of csrc/radix_select.cuh: 2048
#: histogram bins, 32 warp sums, 4 words) and an mbarrier for each of at
#: most _MAX_CHUNKS copies
_SELECT_BYTES = 4 * (2048 + 32 + 4)
_MAX_CHUNKS = 16
_HEAD_BYTES = _SELECT_BYTES + _MAX_CHUNKS * 8
#: values a copy at most (32 KB a bulk copy)
_CHUNK_VALUES = 8192
#: threads a block: a block among others on its SM, or one that has its SM
#: to itself
_THREADS_SHARED, _THREADS_ALONE = 256, 1024
#: what an SM of compute capability 9.0 holds: threads, blocks, registers;
#: the kernel's launch bound (1024 threads) caps a thread at 64 registers;
#: the runtime reserves 1 KB of shared memory a block
_SM_THREADS, _SM_BLOCKS, _SM_REGS = 2048, 32, 65536
_REGS_PER_THREAD = 64
_RESERVED_SMEM = 1024


@dataclasses.dataclass(frozen=True)
class MedianPlan:
    """A launch of csrc/median.cu for rows of G values (see median_plan)."""

    threads: int        # threads a block
    blocks_per_sm: int  # resident blocks an SM
    blocks: int         # the persistent grid (SMs x blocks_per_sm, before
                        # it is cut to the rows)
    capacity: int       # values the row buffer holds (a multiple of 4)
    chunk: int          # values a bulk copy (a multiple of 4: 16-byte offsets)
    chunks: int         # bulk copies a row
    staged: int         # values of every row that are staged
    tail: int           # values of a row read from device memory on each pass
    smem_bytes: int     # dynamic shared memory a block

    def launch_args(self) -> Tuple[int, ...]:
        """The plan as the C entry points take it."""
        return (self.threads, self.blocks_per_sm, self.capacity, self.chunk,
                self.chunks, self.smem_bytes)


def _blocks_per_sm(smem: int, threads: int, smem_optin: int) -> int:
    return min((smem_optin + _RESERVED_SMEM) // (smem + _RESERVED_SMEM),
               _SM_THREADS // threads, _SM_BLOCKS,
               _SM_REGS // (_REGS_PER_THREAD * threads))


def median_plan(G: int, ld: int, smem_optin: int, n_sm: int,
                threads: Optional[int] = None,
                blocks_per_sm: Optional[int] = None) -> MedianPlan:
    """Plan the median kernels' launch for rows of G values and stride ld
    (>= G) on a card whose blocks may opt in to smem_optin bytes of shared
    memory, with n_sm SMs.  Rows are copied into shared memory 16 bytes at
    a time from their first 16-byte boundary, in chunks of at most
    _CHUNK_VALUES: the row buffer holds the largest multiple of 4 values
    <= G that fits beside the select.  Blocks of _THREADS_SHARED threads
    where two such blocks fit an SM, else one block of _THREADS_ALONE.  When
    ld is not a multiple of 4 a row's first 16-byte boundary lies up to 3
    values in (the base is taken to be 16-byte aligned, as PyTorch
    allocates), so such rows stage up to 4 values fewer: staged counts what
    every row stages.  threads and blocks_per_sm override the plan's
    choices, for measurements (the C entry point refuses a plan the card
    cannot hold)."""
    if G <= 0 or ld < G or smem_optin <= _HEAD_BYTES or n_sm <= 0:
        raise ValueError(f"median_plan: G={G}, ld={ld}, smem_optin={smem_optin}, "
                         f"n_sm={n_sm}")
    capacity = min(G // 4 * 4, (smem_optin - _HEAD_BYTES) // 16 * 4)
    chunks = -(-capacity // _CHUNK_VALUES)
    chunk = (-(-capacity // chunks) + 3) // 4 * 4 if chunks else 0
    head = 0 if ld % 4 == 0 else min(3, G)
    staged = min(capacity, (G - head) // 4 * 4)
    smem = _HEAD_BYTES + 4 * capacity
    if threads is None:
        threads = (_THREADS_SHARED
                   if _blocks_per_sm(smem, _THREADS_SHARED, smem_optin) >= 2
                   else _THREADS_ALONE)
    if blocks_per_sm is None:
        blocks_per_sm = _blocks_per_sm(smem, threads, smem_optin)
    if blocks_per_sm < 1:
        raise ValueError(f"median_plan: no block of {threads} threads and "
                         f"{smem} bytes fits an SM")
    return MedianPlan(threads=threads, blocks_per_sm=blocks_per_sm,
                      blocks=n_sm * blocks_per_sm, capacity=capacity,
                      chunk=chunk, chunks=chunks, staged=staged,
                      tail=G - staged, smem_bytes=smem)


#: (opt-in shared memory a block, SMs) of each CUDA device index
_CARDS: dict = {}


def card_plan(G: int, ld: int, device: torch.device) -> MedianPlan:
    """median_plan on a CUDA device's own shared memory and SM count."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _CARDS:
        dev = torch.device("cuda", idx)
        _CARDS[idx] = (_build.max_smem_optin(dev),
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    return median_plan(G, ld, *_CARDS[idx])


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
    tensors take the plain version; CUDA tensors launch the kernel (a 2-D
    tensor whose rows are contiguous, such as the first n columns of a wider
    one, is read in place)."""
    if v.device.type == "cpu":
        return row_median_plain(v)
    global LAUNCHES
    if v.dtype != torch.float32 or v.dim() == 0 or v.shape[-1] == 0:
        raise ValueError(f"row_median: need f32 [..., n > 0], got {v.dtype} "
                         f"{tuple(v.shape)}")
    n = v.shape[-1]
    if v.dim() == 2 and v.stride(1) == 1 and v.stride(0) >= n:
        x, ld = v, v.stride(0)      # rows of a wider tensor, read in place
    else:
        x = v.reshape(-1, n).contiguous()
        ld = n
    med = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    lib = _build.library()
    plan = card_plan(n, ld, x.device)
    with torch.cuda.device(x.device):
        rc = lib.ic_row_median(_build.ptr(x), ld, x.shape[0], n, _build.ptr(med),
                               *plan.launch_args(), _build.stream_of(x))
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
    plan = card_plan(num_genes, yp.shape[1], yp.device)
    with torch.cuda.device(yp.device):
        rc = lib.ic_median_center_residual(
            _build.ptr(yp), yp.shape[1], _build.ptr(gmin), _build.ptr(gmax),
            _build.ptr(out), num_genes, None if med is None else _build.ptr(med),
            C, num_genes, *plan.launch_args(), _build.stream_of(yp))
    _build.check(rc, "median_center_residual")
    LAUNCHES_EPILOGUE += 1
    return (out, med) if with_median else out
