"""The streaming CNV engine, in PyTorch.

Counterpart of infercnv_tpu/parallel/engine.py (lines 38-549, 552-559),
without the ``mesh`` path (multi-GPU is not ported yet).  Cells flow through
in fixed-size chunks; reference statistics are computed once and reused:

  1. ``ref_stats``: per-reference-group gene means for both subtraction
     stages and the pooled denoise bounds (one-shot, or streamed in three
     passes above 2.5e8 reference elements);
  2. ``subcluster_chunk`` / ``transform_chunk`` / ``full_chunk``: the
     residual of a chunk of cells, then denoise and per-subcluster sums, or
     the per-cell Viterbi;
  3. ``viterbi_group_means``: the i6 or i3 Viterbi on subcluster mean rows
     (ops/viterbi_pack.py over the CUDA kernel of ops/viterbi_kernel.py).

Every option of the reference's ``EngineConfig`` runs: pyramidal, runmeans
and coordinate smoothing (``smooth_method="coordinates"``, a bp window), a
bf16 smooth (``matmul_dtype="bfloat16"``), median or mean centring, with or
without bounds.  The residual takes one of three routes, chosen when the
engine is built from the smoothing operator and the card's shared memory,
never by trying a launch (``residual_route``):

  * ``fused``: one CUDA kernel (ops/residual_fused.py) for the whole pass,
    when the band has one side tile (halfband <= 128) and a zero-padded row
    with its smooth's buffers fits in a block's shared memory;
  * ``wide_genome``: otherwise, with halfband <= 64 and median centring:
    normalise, log, bounds and clip as PyTorch ops, the tiled smooth
    (ops/smoothing.py apply_banded_general), and the median-centred tail
    kernel (ops/median.py median_center_residual);
  * ``wide_band``: every other case (coordinate smoothing, halfbands over
    64 that the fused kernel cannot take, mean centring): the same first
    ops and smooth, then the row median kernel (or the row mean), the
    stage-2 bounds and exp2 as PyTorch ops.

On an H100 (227 KB a block) a pyramidal band of 101 genes fits the fused
kernel up to ~56k genes.  That threshold is the card's own: the reference's
TPU threshold is its VMEM budget (residual_fused._pick_tile_r), and the
results are the same on either route.  ``ref_stats`` smooths with the
one-row kernel (halfband <= 64 and the row fits), else with the tiled one.

Every entry point runs on the engine's device: CUDA unless the caller
passes ``device="cpu"``, where each kernel wrapper runs its plain PyTorch
version; the CPU plans its routes with the H100's shared memory
(``SMEM_OPTIN_BYTES``), so that it takes the card's routes.  Float32
products stay full f32 (the group sums are torch.matmul outside any kernel,
as the reference leaves them to XLA).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from infercnv_tpu_torch.core.genome import GeneOrder
from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.models.hmm import HMMParams
from infercnv_tpu_torch.ops import _build, residual_fused as _fused
from infercnv_tpu_torch.ops.layout import (
    coordinate_smoothing_operator,
    smoothing_operator,
)
from infercnv_tpu_torch.ops.median import median_center_residual, row_median
from infercnv_tpu_torch.ops.residual_fused import (
    counts_to_f32,
    denoise,
    residual_fused,
    where_bounds,
)
from infercnv_tpu_torch.ops.smoothing import (
    BandWeights,
    apply_banded,
    apply_banded_general,
)
from infercnv_tpu_torch.ops.viterbi_pack import PackedLayout, viterbi_packed

_OUT_DTYPES = {"float32": torch.float32, "float16": torch.float16,
               "bfloat16": torch.bfloat16}
_NARROW_COUNTS = (torch.uint16, torch.int16, torch.int32, torch.uint32)
#: above this many reference elements the statistics stream over chunks
_STREAM_REF_ELEMENTS = 250_000_000
#: shared memory a block may opt in to on an H100 (227 KB): the capacity the
#: engine plans its routes with on the CPU; a CUDA device reports its own
SMEM_OPTIN_BYTES = 232_448

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Same fields and defaults as the reference's EngineConfig."""

    #: genes in the window, or base pairs for coordinate smoothing
    window_length: int = 101
    #: "pyramidinal" | "runmeans" | "coordinates" (a bp window, as run()
    #: sets it with the i3 HMM; the wide-band route)
    smooth_method: str = "pyramidinal"
    max_centered_threshold: float = 3.0
    ref_subtract_use_bounds: bool = True
    center_method: str = "median"
    denoise: bool = True
    sd_amplifier: float = 1.5
    hmm_t: float = 1e-6
    #: "bfloat16" rounds the smooth's operands to bf16 (f32 sums; each
    #: product within 2^-7 of itself) where the reference's Pallas engine
    #: does: in the fused residual, and in the one-row smooth of ref_stats
    #: and the wide-genome route (halfband <= 64); the f32 default keeps
    #: the 1e-5 parity
    matmul_dtype: str = "float32"
    #: radix digit width of the reference's median select; the median is
    #: exact for every width, and the CUDA kernels always select in three
    #: passes of 11, 11 and 10 bits (csrc/radix_select.cuh)
    median_radix_bits: int = 1
    #: dtype of transform_chunk's residual ("float32" | "float16" |
    #: "bfloat16"); rounding happens only at the final store
    out_dtype: str = "float32"


class CnvEngine:
    """Smoothing + HMM pass for a fixed genome and HMM, on one device."""

    def __init__(self, gene_order: GeneOrder, hmm: HMMParams,
                 config: EngineConfig = EngineConfig(),
                 device: DeviceLike = None):
        if config.matmul_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported matmul_dtype {config.matmul_dtype}")
        if 32 % config.median_radix_bits:
            raise ValueError(
                f"median_radix_bits must divide 32, got {config.median_radix_bits}")
        if config.out_dtype not in _OUT_DTYPES:
            raise ValueError(f"unsupported out_dtype {config.out_dtype}")
        self.device = resolve_device(device)
        self.gene_order = gene_order
        self.config = config
        self.hmm = hmm
        if config.smooth_method == "coordinates":
            # a bp window (run() remaps gene-unit windows to 10 Mbp;
            # reference R/inferCNV_ops.R:357-361)
            op = coordinate_smoothing_operator(gene_order, config.window_length)
        else:
            op = smoothing_operator(
                gene_order, config.window_length,
                "runmeans" if config.smooth_method == "runmeans" else "pyramidinal")
        self.weights = BandWeights.from_operator(op, self.device)
        # bf16 weights where the reference rounds: its fused kernel takes the
        # flag whenever it runs (side_tiles == 1), its K=256 smooth only for
        # halfband <= 64 (engine.py:112-114, :202-205)
        bf16 = config.matmul_dtype == "bfloat16"
        w_bf16 = (BandWeights.from_operator(op, self.device, bf16=True)
                  if bf16 and op.side_tiles == 1 else None)
        self._w_fused = w_bf16 if w_bf16 is not None else self.weights
        self._w_smooth = (w_bf16 if w_bf16 is not None and op.halfband <= 64
                          else self.weights)
        smem = (_build.max_smem_optin(self.device)
                if self.device.type == "cuda" else SMEM_OPTIN_BYTES)
        #: the smooth of ref_stats and of the unfused routes: "row" (one row
        #: a block, smooth_banded.cu) or "general" (smooth_general.cu)
        self.smooth_route = ("row" if op.side_tiles == 1 and op.halfband <= 64
                             and self._w_smooth.row_kernel_fits(smem)
                             else "general")
        #: the residual's route: "fused", "wide_genome" or "wide_band"
        if op.side_tiles == 1 and _fused.fits(self._w_fused, smem):
            self.residual_route = "fused"
        elif op.halfband <= 64 and config.center_method == "median":
            self.residual_route = "wide_genome"
        else:
            self.residual_route = "wide_band"
        self._layout = PackedLayout.from_gene_order(gene_order)
        self._means = np.asarray(hmm.means, np.float32)
        self._sigma = float(np.float32(np.median(hmm.sds)))

    # ------------------------------------------------------------------
    # numerics
    # ------------------------------------------------------------------

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def _subtract(self, x, grp_means):
        if self.config.ref_subtract_use_bounds:
            return where_bounds(x, grp_means.amin(dim=0), grp_means.amax(dim=0))
        return x - grp_means.mean(dim=0)

    def _centre(self, x):
        if self.config.center_method == "median":
            return x - row_median(x)[:, None]
        return x - x.mean(dim=1, keepdim=True)

    def _log_norm(self, counts, nf):
        c = counts_to_f32(counts)
        cs = c.sum(dim=1, keepdim=True)
        return torch.log2(c / cs * nf + 1.0)

    def _smooth(self, x):
        if self.smooth_route == "row":
            return apply_banded(x, self._w_smooth)
        return apply_banded_general(x, self._w_smooth)

    def _clipped_x(self, counts, nf, ref_means_log):
        """Normalise + log2, stage-1 bounds, clip: the first ops of every
        unfused residual (reference engine.py:252-255)."""
        x = self._subtract(self._log_norm(counts, nf), ref_means_log)
        mct = self.config.max_centered_threshold
        return torch.clamp(x, -mct, mct)

    def _stage2_x(self, counts, nf, ref_means_log):
        return self._centre(self._smooth(self._clipped_x(counts, nf,
                                                         ref_means_log)))

    def _residual(self, counts, norm_factor, ref_means_log, ref_means_resid,
                  out_dtype: torch.dtype = torch.float32, noise_bounds=None):
        """The residual on the engine's route.  The where-form bounds with
        min == max == mean equal ``x - mean`` exactly, so the no-bounds
        configuration takes the same kernels.  With noise_bounds it returns
        (residual, denoised residual)."""
        cfg = self.config
        if cfg.ref_subtract_use_bounds:
            b1min, b1max = ref_means_log.amin(dim=0), ref_means_log.amax(dim=0)
            b2min, b2max = ref_means_resid.amin(dim=0), ref_means_resid.amax(dim=0)
        else:
            b1min = b1max = ref_means_log.mean(dim=0)
            b2min = b2max = ref_means_resid.mean(dim=0)
        if self.residual_route == "fused":
            return residual_fused(
                counts, self._w_fused, b1min.contiguous(), b1max.contiguous(),
                b2min.contiguous(), b2max.contiguous(), norm_factor,
                mct=cfg.max_centered_threshold,
                center_mean=(cfg.center_method != "median"),
                out_dtype=out_dtype, noise_bounds=noise_bounds)
        # a Python float multiplies as f32, without a host-to-device copy
        # (a blocking copy would stall the stream once a chunk)
        y = self._smooth(self._clipped_x(counts, float(norm_factor),
                                         ref_means_log))
        if self.residual_route == "wide_genome":
            resid = median_center_residual(y, b2min.contiguous(),
                                           b2max.contiguous(), y.shape[1])
        else:
            resid = torch.exp2(where_bounds(self._centre(y), b2min, b2max))
        if noise_bounds is not None:
            return resid, denoise(resid, noise_bounds)
        return resid.to(out_dtype)

    def _residual_and_final(self, counts, norm_factor, ref_means_log,
                            ref_means_resid, noise_bounds):
        """(pre-denoise residual, returned residual): the second is denoised
        when config.denoise (the Viterbi and the group sums read the first)."""
        counts = _counts_cast(counts, self.device)
        if not self.config.denoise:
            resid = self._residual(counts, norm_factor, ref_means_log,
                                   ref_means_resid)
            return resid, resid
        if noise_bounds is None:
            noise_bounds = torch.zeros(2, dtype=torch.float32, device=self.device)
        return self._residual(counts, norm_factor, ref_means_log,
                              ref_means_resid,
                              noise_bounds=self._f32(noise_bounds))

    def _viterbi(self, resid, sigma_rows=None):
        """Per-row Viterbi over bin-packed chromosomes; sigma_rows [C]
        defaults to the median hspike sigma."""
        if sigma_rows is None:
            sigma_rows = torch.full((resid.shape[0],), self._sigma,
                                    dtype=torch.float32, device=self.device)
        return viterbi_packed(resid, self._layout, self._means, sigma_rows,
                              self.hmm.t)

    # ------------------------------------------------------------------
    # reference statistics
    # ------------------------------------------------------------------

    def _ref_stats_oneshot(self, ref_counts, nf, group_onehot) -> Stats:
        xlog = self._log_norm(ref_counts, nf)
        gn = group_onehot.sum(dim=1, keepdim=True)
        ref_means_log = (group_onehot @ xlog) / gn
        x = self._subtract(xlog, ref_means_log)
        mct = self.config.max_centered_threshold
        x = self._centre(self._smooth(torch.clamp(x, -mct, mct)))
        ref_means_resid = (group_onehot @ x) / gn
        # denoise bounds on the pooled reference residuals (:2302-2346)
        final = torch.exp2(self._subtract(x, ref_means_resid))
        mean_ref = final.mean()
        sd_ref = final.std(dim=1, correction=1).mean() * self.config.sd_amplifier
        return ref_means_log, ref_means_resid, torch.stack([mean_ref, sd_ref])

    def _ref_stats_streamed(self, ref_counts, norm_factor, group_onehot,
                            chunk: int = 16384) -> Stats:
        """ref_stats accumulated over cell chunks in three passes, sums in
        float64 on the host: the same statistics as the one-shot form to f32
        rounding (the accumulation order differs)."""
        R = ref_counts.shape[0]
        G = self.gene_order.num_genes
        K = group_onehot.shape[0]
        nf = self._f32(norm_factor)
        onehot = _host_f32(group_onehot)
        gn = onehot.sum(axis=1)[:, None]

        def chunks():
            for b in range(0, R, chunk):
                c = _counts_cast(ref_counts[b:b + chunk], self.device)
                yield c, self._f32(np.ascontiguousarray(onehot[:, b:b + chunk]))

        gsum = np.zeros((K, G), np.float64)
        for c, oh in chunks():
            gsum += (oh @ self._log_norm(c, nf)).double().cpu().numpy()
        ml = self._f32((gsum / gn).astype(np.float32))
        gsum2 = np.zeros((K, G), np.float64)
        for c, oh in chunks():
            gsum2 += (oh @ self._stage2_x(c, nf, ml)).double().cpu().numpy()
        mr = self._f32((gsum2 / gn).astype(np.float32))
        total = 0.0
        sd_sum = 0.0
        for c, _oh in chunks():
            final = torch.exp2(self._subtract(self._stage2_x(c, nf, ml), mr))
            total += float(final.sum())
            sd_sum += float(final.std(dim=1, correction=1).sum())
        mean_ref = total / (R * G)
        sd_ref = (sd_sum / R) * self.config.sd_amplifier
        return ml, mr, self._f32(np.array([mean_ref, sd_ref], np.float32))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def ref_stats(self, ref_counts, norm_factor, group_onehot=None) -> Stats:
        """(ref_means_log [K, G], ref_means_resid [K, G], noise_bounds [2] =
        (mean_ref, sd spread * amplifier)) from the reference cells.
        group_onehot: [K, n_ref] membership (None = one pooled group)."""
        if group_onehot is None:
            group_onehot = np.ones((1, ref_counts.shape[0]), np.float32)
        if int(np.prod(ref_counts.shape)) > _STREAM_REF_ELEMENTS:
            return self._ref_stats_streamed(ref_counts, norm_factor, group_onehot)
        counts = _counts_cast(ref_counts, self.device)
        return self._ref_stats_oneshot(counts, self._f32(norm_factor),
                                       self._f32(group_onehot))

    def transform_chunk(self, counts, norm_factor, ref_means_log,
                        ref_means_resid) -> torch.Tensor:
        """Pre-denoise residual of one cell chunk, in config.out_dtype."""
        return self._residual(_counts_cast(counts, self.device), norm_factor,
                              ref_means_log, ref_means_resid,
                              _OUT_DTYPES[self.config.out_dtype])

    def full_chunk(self, counts, norm_factor, ref_means_log, ref_means_resid,
                   noise_bounds=None):
        """Residual + per-cell HMM states of one chunk (analysis_mode='cells').
        The Viterbi reads the pre-denoise residual; the returned residual is
        denoised when config.denoise and noise_bounds are given."""
        resid, final = self._residual_and_final(
            counts, norm_factor, ref_means_log, ref_means_resid, noise_bounds)
        return final, self._viterbi(resid)

    def subcluster_chunk(self, counts, norm_factor, ref_means_log,
                         ref_means_resid, noise_bounds, group_onehot,
                         acc: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Default-configuration streaming step (analysis_mode='subclusters'):
        returns (final resid [C, G] (denoised per config), accumulated
        subcluster sums [K, G], accumulated subcluster counts [K]).  Pass the
        previous call's (sums, counts) back via ``acc``."""
        onehot = self._f32(group_onehot)
        if acc is None:
            K, G = onehot.shape[0], self.gene_order.num_genes
            acc = (torch.zeros((K, G), dtype=torch.float32, device=self.device),
                   torch.zeros((K,), dtype=torch.float32, device=self.device))
        resid, final = self._residual_and_final(
            counts, norm_factor, ref_means_log, ref_means_resid, noise_bounds)
        return final, acc[0] + onehot @ resid, acc[1] + onehot.sum(dim=1)

    def viterbi_group_means(self, group_means, n_cells_per_group=None,
                            trend_fits=None, levels=None) -> torch.Tensor:
        """Viterbi on subcluster mean rows (reference
        predict_CNV_via_HMM_on_tumor_subclusters R/inferCNV_HMM.R:345-408).
        With trend_fits, each group's emission sigma follows the hspike
        cell-count trend (.get_state_emission_params :586-614) collapsed to
        its median over states (:1122).  Returns int8 states [K, G] (1-based)."""
        group_means = self._f32(group_means)
        K = group_means.shape[0]
        if trend_fits is not None and n_cells_per_group is not None:
            from infercnv_tpu_torch.models.hmm import I6_LEVELS, state_emission_sds

            lv = levels if levels is not None else I6_LEVELS
            counts = (n_cells_per_group.cpu().numpy()
                      if torch.is_tensor(n_cells_per_group)
                      else np.asarray(n_cells_per_group))
            sigma_rows = np.array([
                float(np.median(state_emission_sds(int(n), trend_fits, lv)))
                for n in counts], np.float32)
        else:
            sigma_rows = np.full((K,), self._sigma, np.float32)
        return self._viterbi(group_means, self._f32(sigma_rows))


def _host_f32(a) -> np.ndarray:
    """A numpy float32 copy of an array or a tensor on any device."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _counts_cast(counts, device) -> torch.Tensor:
    """Keep 16/32-bit integer counts in their narrow dtype (the residual
    kernel converts them as it reads); anything else becomes float32."""
    t = torch.as_tensor(counts)
    if t.dtype not in _NARROW_COUNTS:
        t = t.to(torch.float32)
    return t.to(device).contiguous()
