"""The whole default residual pass: counts in, final (pre-denoise) residual out.

Counterpart of infercnv_tpu/ops/residual_fused.py.  ``residual_fused`` is
the wrapper of the CUDA kernel ``csrc/residual_fused.cu``, which replaces the
TPU kernel ``_residual_band_kernel`` (``residual_fused_pallas``, lines
95-268).  ``residual_fused_plain`` is the same function as separate PyTorch
ops in the reference's op order (the unfused path of
infercnv_tpu/parallel/engine.py:252-292):

  normalise + log2, stage-1 bounds (where-form), clip, banded smooth,
  exact row median (or mean), stage-2 bounds, exp2, cast at the store.

Bounds are per-gene rows: ``b*min == b*max == mean`` reproduces the
``ref_subtract_use_bounds=False`` configuration exactly.  Given the denoise
bounds, the pass also returns the denoised residual (``denoise``), which the
kernel writes in the same pass.  Given bf16 weights
(``BandWeights(bf16=True)``), the smooth's operands are rounded to bf16 and
summed in f32: the reference kernel's ``bf16`` flag
(infercnv_tpu/ops/residual_fused.py:138-143, ``matmul_dtype="bfloat16"``).

``ref_centred`` runs the same kernel's front as a kernel of its own name
(``ref_centred_kernel``): counts in, the centred x before the stage-2
bounds out, for ``CnvEngine.ref_stats``; ``ref_centred_plain`` is those
first ops of ``residual_fused_plain``.
"""

from __future__ import annotations

from typing import Optional

import torch

from infercnv_tpu_torch.ops import _build
from infercnv_tpu_torch.ops.median import row_median_plain
from infercnv_tpu_torch.ops.smoothing import BandWeights, apply_banded_plain, swz_row_len

#: launches of the CUDA kernel (the plain version does not count), with f32
#: weights and with bf16 ones (the reference's bf16 flag), and of its front
#: (either weights)
LAUNCHES = 0
LAUNCHES_BF16 = 0
LAUNCHES_CENTRED = 0

#: the median select's shared memory (sizeof(SelectSmem) of
#: csrc/radix_select.cuh: 2048 histogram bins, 32 warp sums, 4 words)
_SELECT_BYTES = 4 * (2048 + 32 + 4)
#: threads a block and outputs a thread in the kernel's smooth (kResThreads,
#: kGroup): a round of the in-place smooth must span the halfband
_THREADS, _GROUP = 256, 8

_IN_CODES = {torch.float32: 0, torch.uint16: 1, torch.int16: 2,
             torch.int32: 3, torch.uint32: 4}
_OUT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def counts_to_f32(counts: torch.Tensor) -> torch.Tensor:
    """Exact counts -> float32 (unsigned types widen through a signed view,
    which every device supports)."""
    if counts.dtype == torch.uint16:
        counts = counts.view(torch.int16).to(torch.int32) & 0xFFFF
    elif counts.dtype == torch.uint32:
        counts = counts.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return counts.to(torch.float32)


def where_bounds(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Values inside [lo, hi] go to 0, values outside lose the nearer bound
    (reference .subtract_expr, R/inferCNV_ops.R:1742-1786)."""
    above = torch.where(x > hi, x - hi, torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.where(x < lo, x - lo, above)


def denoise(resid: torch.Tensor, noise_bounds: torch.Tensor) -> torch.Tensor:
    """clear_noise_via_ref_mean_sd (reference inferCNV_ops.R:2302-2346):
    values inside mean_ref +- spread go to the reference mean.
    noise_bounds = [mean_ref, spread]."""
    mean_ref, spread = noise_bounds[0], noise_bounds[1]
    inside = (resid > mean_ref - spread) & (resid < mean_ref + spread)
    return torch.where(inside, mean_ref, resid)


def smem_bytes(w: BandWeights) -> int:
    """Shared memory of a block of the kernel (residual_smem_bytes of
    csrc/residual_fused.cu): the common column and its f32 form, the
    swizzled row with its gaps and pads, the scaled items' results (bf16)
    and the general genes', the segment starts, the segment of each group
    of 8 genes (2 bytes), 32 block sums and the select."""
    p, t4, G = w.plan, w.halfband4, w.num_genes
    row = swz_row_len(p.span, t4)
    extra = 8 * p.sitems.shape[0] + p.general.shape[0]
    return (4 * (2 * (2 * t4 + 4) + row + extra + p.seg.shape[0]
                 + (G + 15) // 16 + 32)
            + _SELECT_BYTES)


def fits(w: BandWeights, smem_optin: int) -> bool:
    """Whether the kernel takes this band and row: one block holds the
    whole zero-padded row and its smooth's buffers in shared memory."""
    return (w.halfband4 + 8 <= _THREADS * _GROUP
            and smem_bytes(w) <= smem_optin)


def ref_centred_plain(counts: torch.Tensor, w: BandWeights, b1min, b1max,
                      norm_factor: float, mct: float = 3.0,
                      center_mean: bool = False) -> torch.Tensor:
    c = counts_to_f32(counts)
    nf = torch.tensor(norm_factor, dtype=torch.float32, device=c.device)
    cs = c.sum(dim=1, keepdim=True)
    x = torch.log2(c / cs * nf + 1.0)
    x = where_bounds(x, b1min, b1max)
    x = torch.clamp(x, -mct, mct)
    y = apply_banded_plain(x, w)
    if center_mean:
        centre = y.sum(dim=1, keepdim=True) / float(w.num_genes)
    else:
        centre = row_median_plain(y)[:, None]
    return y - centre


def residual_fused_plain(counts: torch.Tensor, w: BandWeights,
                         b1min, b1max, b2min, b2max, norm_factor: float,
                         mct: float = 3.0, center_mean: bool = False,
                         out_dtype: torch.dtype = torch.float32,
                         noise_bounds: Optional[torch.Tensor] = None):
    y = ref_centred_plain(counts, w, b1min, b1max, norm_factor, mct,
                          center_mean)
    resid = torch.exp2(where_bounds(y, b2min, b2max))
    if noise_bounds is not None:
        return resid, denoise(resid, noise_bounds)
    return resid.to(out_dtype)


def residual_fused(counts: torch.Tensor, w: BandWeights,
                   b1min: torch.Tensor, b1max: torch.Tensor,
                   b2min: torch.Tensor, b2max: torch.Tensor,
                   norm_factor: float, mct: float = 3.0,
                   center_mean: bool = False,
                   out_dtype: torch.dtype = torch.float32,
                   noise_bounds: Optional[torch.Tensor] = None):
    """counts [C, G] (f32, u16, i16, i32 or u32) -> residual [C, G] in
    out_dtype (f32, f16 or bf16; every intermediate stays f32, so a narrow
    output equals the cast of the f32 one).  b*: [G] f32 bound rows.  With
    noise_bounds ([2] f32: mean_ref, spread; f32 output only) it returns
    (residual, denoise(residual, noise_bounds)).  With bf16 weights the
    smooth rounds its operands to bf16.  CPU tensors take the plain version;
    CUDA tensors launch the kernel, which needs fits(w, ...)."""
    if counts.device.type == "cpu":
        return residual_fused_plain(counts, w, b1min, b1max, b2min, b2max,
                                    norm_factor, mct, center_mean, out_dtype,
                                    noise_bounds)
    global LAUNCHES, LAUNCHES_BF16
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"residual_fused: out_dtype {out_dtype} not in "
                         f"{list(_OUT_CODES)}")
    out = torch.empty(counts.shape, dtype=out_dtype, device=counts.device)
    noise = denoised = None
    if noise_bounds is not None:
        if out_dtype != torch.float32:
            raise ValueError("residual_fused: the denoised output needs f32 out")
        noise = noise_bounds.to(torch.float32).reshape(2).contiguous()
        _build.check_inputs("residual_fused", counts, noise)
        denoised = torch.empty(counts.shape, dtype=torch.float32,
                               device=counts.device)
    _launch("residual_fused", counts, w, (b1min, b1max, b2min, b2max),
            norm_factor, mct, center_mean, out, _OUT_CODES[out_dtype],
            noise, denoised)
    if w.bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return out if denoised is None else (out, denoised)


def ref_centred(counts: torch.Tensor, w: BandWeights, b1min: torch.Tensor,
                b1max: torch.Tensor, norm_factor: float, mct: float = 3.0,
                center_mean: bool = False) -> torch.Tensor:
    """counts [C, G] -> the centred x [C, G] f32 of residual_fused before
    its stage-2 bounds (kernel 1's steps 1-5: normalise, log2, stage-1
    bounds, clip, smooth, median or mean centre).  CPU tensors take the
    plain version; CUDA tensors launch ``ref_centred_kernel``, which needs
    fits(w, ...)."""
    if counts.device.type == "cpu":
        return ref_centred_plain(counts, w, b1min, b1max, norm_factor, mct,
                                 center_mean)
    global LAUNCHES_CENTRED
    out = torch.empty(counts.shape, dtype=torch.float32, device=counts.device)
    _launch("ref_centred", counts, w, (b1min, b1max), norm_factor, mct,
            center_mean, out, -1)
    LAUNCHES_CENTRED += 1
    return out


def _launch(name: str, counts: torch.Tensor, w: BandWeights, bounds,
            norm_factor: float, mct: float, center_mean: bool,
            out: torch.Tensor, out_code: int, noise=None, denoised=None):
    """ic_residual_fused on checked inputs: bounds are b1min, b1max and,
    except for the front (out_code -1), b2min, b2max."""
    if counts.dtype not in _IN_CODES:
        raise ValueError(f"{name}: counts dtype {counts.dtype} not in "
                         f"{list(_IN_CODES)}")
    G = w.num_genes
    if counts.dim() != 2 or counts.shape[1] != G:
        raise ValueError(f"{name}: counts {tuple(counts.shape)} for {G} genes")
    bounds = [b.reshape(-1) for b in bounds]
    for b in bounds:
        if b.dtype != torch.float32 or b.shape[0] != G:
            raise ValueError(f"{name}: bounds must be f32 rows of G")
    _build.check_inputs(name, counts, w.band4, w.common, *w.row.values(),
                        *bounds)
    ptrs = [_build.ptr(b) for b in bounds] + [None] * (4 - len(bounds))
    with torch.cuda.device(counts.device):
        rc = _build.library().ic_residual_fused(
            _build.ptr(counts), _IN_CODES[counts.dtype], *w.fused_args(),
            *ptrs, float(norm_factor), float(mct), int(center_mean),
            int(w.bf16), _build.ptr(out), out_code,
            None if noise is None else _build.ptr(noise),
            None if denoised is None else _build.ptr(denoised),
            counts.shape[0], G, w.halfband4, _build.stream_of(counts))
    _build.check(rc, name)
