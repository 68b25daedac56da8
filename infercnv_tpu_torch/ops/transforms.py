"""Elementwise and reduction matrix ops of the pipeline, in PyTorch.

Counterpart of infercnv_tpu/ops/transforms.py (every function).  All ops
take and return ``[C, G]`` matrices (cells-major).  Where the reference
computes with ``jnp``, the port computes with torch on ``device`` (CUDA
unless the caller passes "cpu"; a tensor argument keeps its own device when
``device`` is None) and returns a float32 tensor.  Where the reference keeps
a numpy input on the host (the depth normalisation, the denoise ops, the
gene filters), the port copies that numpy as it is, dtypes included, and
returns numpy; given a tensor, those ops compute with torch on its device.
``center_cells(..., "median")`` takes each row's exact median with
ops/median.py ``row_median`` (the CUDA kernel on the card, numpy's median
bit for bit, the even-width mean of the two middles included).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.ops.median import row_median
from infercnv_tpu_torch.utils.memmap import gather_rows, read_rows, write_rows


def _f32(x, device: DeviceLike = None) -> torch.Tensor:
    """x as a float32 tensor on `device` (a tensor's own device when None)."""
    if torch.is_tensor(x) and device is None:
        return x.to(torch.float32)
    dev = resolve_device(device)
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=torch.float32)
    a = np.asarray(x, np.float32)
    if not a.flags.writeable:     # torch only wraps writable arrays
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def group_onehot(groups: Sequence[np.ndarray], num_cells: int) -> np.ndarray:
    """[n_groups, C] 0/1 membership matrix (host-precomputed, static)."""
    M = np.zeros((len(groups), num_cells), np.float32)
    for i, idx in enumerate(groups):
        M[i, np.asarray(idx)] = 1.0
    return M


# ---------------------------------------------------------------------------
# normalization / transforms
# ---------------------------------------------------------------------------

def normalize_counts_by_seq_depth(x, normalize_factor: Optional[float] = None):
    """Per-cell total-count scaling (reference R/inferCNV_ops.R:3064-3111):
    counts / colSums * median(colSums) (or a given factor).  Host numpy on
    host arrays, as the reference does; a tensor stays on its device."""
    if torch.is_tensor(x):
        x = x.to(torch.float32)
        cs = x.sum(dim=1, keepdim=True)
        factor = (row_median(cs[:, 0]) if normalize_factor is None
                  else float(np.float32(normalize_factor)))
        return x / cs * factor
    x = np.asarray(x, np.float32)
    cs = x.sum(axis=1, keepdims=True)
    factor = (np.float32(np.median(cs[:, 0])) if normalize_factor is None
              else np.float32(normalize_factor))
    return x / cs * factor


def log2xplus1(x, device: DeviceLike = None) -> torch.Tensor:
    """log2(x + 1) (reference :2756-2769)."""
    return torch.log2(_f32(x, device) + 1.0)


def invert_log2xplus1(x, device: DeviceLike = None) -> torch.Tensor:
    """2^x - 1 (reference :2786-2798)."""
    return torch.exp2(_f32(x, device)) - 1.0


def invert_log2(x, device: DeviceLike = None) -> torch.Tensor:
    """2^x (reference :2814-2826)."""
    return torch.exp2(_f32(x, device))


def anscombe_transform(x, device: DeviceLike = None) -> torch.Tensor:
    """2*sqrt(x + 3/8) (reference :3130-3141)."""
    return 2.0 * torch.sqrt(_f32(x, device) + 3.0 / 8.0)


def add_pseudocount(x, pseudocount: float = 1.0,
                    device: DeviceLike = None) -> torch.Tensor:
    """x + pseudocount (reference add_pseudocount :3146-3158)."""
    return _f32(x, device) + pseudocount


def make_zero_NA(x, device: DeviceLike = None) -> torch.Tensor:
    """Zeros -> NaN (reference make_zero_NA :2837-2860)."""
    x = _f32(x, device)
    return torch.where(x == 0, torch.full_like(x, float("nan")), x)


def _quantile_rows(x: torch.Tensor, q: float) -> torch.Tensor:
    """Per-row quantile with linear interpolation (numpy's default)."""
    s, _ = torch.sort(x, dim=1)
    pos = q * (x.shape[1] - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, x.shape[1] - 1)
    frac = pos - lo
    return s[:, lo:lo + 1] + (s[:, hi:hi + 1] - s[:, lo:lo + 1]) * frac


def normalize_by_upper_quartile(x, device: DeviceLike = None) -> torch.Tensor:
    """Cross-cell upper-quartile normalization (reference
    upper_quartile_norm :3193-3212): each cell scaled by its 75th
    percentile, rescaled by the mean upper quartile."""
    x = _f32(x, device)
    uq = _quantile_rows(x, 0.75)
    uq = torch.where(uq == 0, torch.ones_like(uq), uq)
    return x / uq * uq.mean()


# ---------------------------------------------------------------------------
# gene filters (host numpy, as the reference)
# ---------------------------------------------------------------------------

def below_min_mean_expr_cutoff(x, min_mean_expr: float) -> np.ndarray:
    """Indices of genes whose mean across all cells < cutoff
    (reference .below_min_mean_expr_cutoff :2154-2163).  The reference's
    float32 column sums run row after row; they are carried over blocks of
    rows in that order (each block's sum starts from the running one), so
    no float32 copy of the whole matrix is made; a disk memmap's rows are
    read through its file (utils/memmap.py)."""
    C = x.shape[0]
    if x.ndim != 2 or x.shape[1] < 2 or C <= 8192:
        # one gene: numpy sums the column pairwise, not row after row
        means = np.asarray(x, np.float32).mean(axis=0)
        return np.nonzero(means < min_mean_expr)[0]
    total = np.zeros((1, x.shape[1]), np.float32)
    for b in range(0, C, 8192):
        block = np.asarray(read_rows(x, b, b + 8192), np.float32)
        total = np.concatenate([total, block]).sum(axis=0, keepdims=True)
    means = total[0] / np.float32(C)
    return np.nonzero(means < min_mean_expr)[0]


def genes_below_min_cells_ref(x, min_cells_per_gene: int) -> np.ndarray:
    """Indices of genes expressed (>0) in fewer than `min_cells_per_gene`
    cells (reference require_above_min_cells_ref :2182-2213)."""
    x = x if isinstance(x, np.ndarray) else np.asarray(x)   # a memmap stays one
    n_expressed = np.zeros(x.shape[1], np.int64)
    for b in range(0, x.shape[0], 8192):
        n_expressed += np.count_nonzero(read_rows(x, b, b + 8192) > 0, axis=0)
    return np.nonzero(n_expressed < min_cells_per_gene)[0]


# ---------------------------------------------------------------------------
# reference subtraction
# ---------------------------------------------------------------------------

def ref_group_gene_means(x, ref_onehot, inv_log: bool = False,
                         device: DeviceLike = None) -> torch.Tensor:
    """[n_ref_groups, G] per-gene means over each reference group
    (reference .get_normal_gene_mean_bounds :1708-1735).  With inv_log, the
    mean is taken in count space: log2(mean(2^x - 1) + 1)."""
    x = _f32(x, device)
    M = _f32(ref_onehot, x.device)
    counts = M.sum(dim=1, keepdim=True)
    if inv_log:
        means = (M @ (torch.exp2(x) - 1.0)) / counts
        return torch.log2(means + 1.0)
    return (M @ x) / counts


def subtract_ref_expr(x, grp_means, use_bounds: bool = True,
                      device: DeviceLike = None) -> torch.Tensor:
    """Subtract the reference expression profile per gene
    (reference subtract_ref_expr_from_obs :1678-1702, .subtract_expr
    :1742-1786).  use_bounds=True: values within [min, max] of the
    per-group means go to 0; values outside subtract the nearest bound.
    Otherwise subtract the mean of the group means."""
    x = _f32(x, device)
    grp_means = _f32(grp_means, x.device)
    if use_bounds:
        gmin = grp_means.amin(dim=0)
        gmax = grp_means.amax(dim=0)
        out = torch.where(x > gmax, x - gmax, torch.zeros_like(x))
        return torch.where(x < gmin, x - gmin, out)
    return x - grp_means.mean(dim=0)


# ---------------------------------------------------------------------------
# clamping / centering / outliers
# ---------------------------------------------------------------------------

def apply_max_threshold_bounds(x, threshold: float,
                               device: DeviceLike = None) -> torch.Tensor:
    """Clamp to +-threshold (reference :2970-2983)."""
    return torch.clamp(_f32(x, device), -threshold, threshold)


def center_cells(x, method: str = "median",
                 device: DeviceLike = None) -> torch.Tensor:
    """Per-cell (row) centering by median or mean (reference
    center_cell_expr_across_chromosome :2074-2088, .center_columns
    :2094-2109).  The median is the exact row median (kernel 7 on the
    card)."""
    x = _f32(x, device).contiguous()
    if method == "median":
        return x - row_median(x)[:, None]
    return x - x.mean(dim=1, keepdim=True)


def get_average_bounds(x, device: DeviceLike = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean of per-cell minima, mean of per-cell maxima) (reference
    .get_average_bounds :2734-2742: quantile()[1]/[5] are min/max)."""
    x = _f32(x, device)
    return x.amin(dim=1).mean(), x.amax(dim=1).mean()


def remove_outliers_norm(x, out_method: str = "average_bound",
                         lower_bound: Optional[float] = None,
                         upper_bound: Optional[float] = None,
                         device: DeviceLike = None) -> torch.Tensor:
    """Clamp outliers (reference remove_outliers_norm :1969-2054)."""
    x = _f32(x, device)
    if lower_bound is not None and upper_bound is not None:
        lo, hi = float(lower_bound), float(upper_bound)
    elif out_method == "average_bound":
        lo, hi = (float(v) for v in get_average_bounds(x))
    else:
        raise ValueError("must specify out_method='average_bound' or both bounds")
    return torch.clamp(x, lo, hi)


# ---------------------------------------------------------------------------
# denoising (host numpy on host arrays, as the reference)
# ---------------------------------------------------------------------------

def clear_noise(x, threshold: float, center_pos: float = 0.0):
    """Values strictly inside (center-threshold, center+threshold) -> center
    (reference .clear_noise :2302-2346 helper at :2232-2278)."""
    if not torch.is_tensor(x):
        x = np.asarray(x, np.float32)
        if threshold == 0:
            return x
        inside = (x > center_pos - threshold) & (x < center_pos + threshold)
        return np.where(inside, np.float32(center_pos), x)
    x = x.to(torch.float32)
    if threshold == 0:
        return x
    inside = (x > center_pos - threshold) & (x < center_pos + threshold)
    return torch.where(inside, torch.full_like(x, center_pos), x)


def ref_mean_sd_bounds(x, ref_idx: np.ndarray, sd_amplifier: float = 1.5):
    """(mean_ref, mean of per-ref-cell sd * amplifier) (reference
    clear_noise_via_ref_mean_sd :2302-2346; sd is the per-cell sample sd
    across genes, ddof=1)."""
    if torch.is_tensor(x):
        vals = x.to(torch.float32)[torch.as_tensor(np.asarray(ref_idx),
                                                   device=x.device)]
        mean_ref = vals.mean()
        G = vals.shape[1]
        percell_sd = (vals.std(dim=1, correction=1) if G > 1
                      else torch.zeros(vals.shape[0], device=x.device))
        return mean_ref, percell_sd.mean() * sd_amplifier
    vals = gather_rows(x, ref_idx).astype(np.float32, copy=False)
    mean_ref = np.float32(vals.mean())
    G = vals.shape[1]
    percell_sd = (vals.std(axis=1, ddof=1) if G > 1
                  else np.zeros(vals.shape[0], np.float32))
    return mean_ref, np.float32(percell_sd.mean() * sd_amplifier)


def clear_noise_via_ref_mean_sd(x, ref_idx: np.ndarray, sd_amplifier: float = 1.5,
                                inplace: bool = False):
    """inplace=True updates a host float32 matrix block by block with no
    full-size temporaries and returns that matrix itself (a disk memmap
    stays one, each block written through its file, utils/memmap.py); the
    caller must own the buffer (run() does: the engine's output)."""
    mean_ref, spread = ref_mean_sd_bounds(x, ref_idx, sd_amplifier)
    if torch.is_tensor(x):
        x = x.to(torch.float32)
        inside = (x > mean_ref - spread) & (x < mean_ref + spread)
        return torch.where(inside, mean_ref, x)
    lo, hi = mean_ref - spread, mean_ref + spread
    if inplace:
        for b in range(0, x.shape[0], 16384):
            blk = read_rows(x, b, b + 16384)
            blk[(blk > lo) & (blk < hi)] = np.float32(mean_ref)
            write_rows(x, b, blk)
        return x
    x = np.asarray(x, np.float32)
    inside = (x > lo) & (x < hi)
    return np.where(inside, np.float32(mean_ref), x)


def depress_log_signal_midpt_val(x, center: float, delta_midpt: float,
                                 slope: float = 20.0):
    """Logistic soft noise shrink (reference inferCNV_heatmap.R:2783-2810,
    .logistic in SplatterScrape.R:210): each value is pulled toward `center`
    by p = logistic(|x - center|; midpoint=delta_midpt, slope)."""
    if not torch.is_tensor(x):
        x = np.asarray(x, np.float32)
        delta = np.abs(x - center)
        p = 1.0 / (1.0 + np.exp(-slope * (delta - delta_midpt)))
        return (center + np.sign(x - center) * delta * p).astype(np.float32)
    x = x.to(torch.float32)
    delta = (x - center).abs()
    p = 1.0 / (1.0 + torch.exp(-slope * (delta - delta_midpt)))
    return center + torch.sign(x - center) * delta * p


# ---------------------------------------------------------------------------
# z-scoring / scaling
# ---------------------------------------------------------------------------

def scale_infercnv_expr(x, device: DeviceLike = None) -> torch.Tensor:
    """Per-gene z-score across cells (reference scale_infercnv_expr
    :3174-3185; R scale() uses ddof=1)."""
    x = _f32(x, device)
    mu = x.mean(dim=0, keepdim=True)
    sd = x.std(dim=0, correction=1, keepdim=True)
    return (x - mu) / torch.where(sd == 0, torch.ones_like(sd), sd)


def transform_to_reference_based_zscores(x, ref_idx: np.ndarray,
                                         device: DeviceLike = None) -> torch.Tensor:
    """Ref-based z-scores with Poisson floor sd >= sqrt(mean)
    (reference transform_to_reference_based_Zscores :2874-2907)."""
    x = _f32(x, device)
    ref = x[torch.as_tensor(np.asarray(ref_idx), device=x.device)]
    mu = ref.mean(dim=0)
    sd = ref.std(dim=0, correction=1)
    sd = torch.maximum(sd, torch.sqrt(torch.clamp(mu, min=0.0)))
    sd = torch.where(sd == 0, torch.ones_like(sd), sd)
    return (x - mu) / sd


def mean_center_gene_expr(x, device: DeviceLike = None) -> torch.Tensor:
    """Per-gene mean centering (reference mean_center_gene_expr :2940-2952)."""
    x = _f32(x, device)
    return x - x.mean(dim=0, keepdim=True)


# ---------------------------------------------------------------------------
# chromosome-end trimming (host numpy)
# ---------------------------------------------------------------------------

def remove_tails_indices(chr_indices: np.ndarray, tail_length: int) -> np.ndarray:
    """Gene indices to drop at both ends of one chromosome
    (reference .remove_tails R/inferCNV_ops.R:2370-2386)."""
    chr_indices = np.asarray(chr_indices)
    n = chr_indices.shape[0]
    if tail_length < 3 or n < 3:
        return np.zeros((0,), np.int64)
    if n < tail_length * 2:
        tail_length = n // 3
    return np.concatenate([chr_indices[:tail_length], chr_indices[n - tail_length:]])


def genes_at_chr_ends(gene_order, window_length: int) -> np.ndarray:
    """All gene indices within (w-1)/2 of chromosome ends
    (reference remove_genes_at_ends_of_chromosomes :3000-3044)."""
    tail = (window_length - 1) // 2
    out: List[np.ndarray] = []
    for (b, e) in gene_order.chr_ranges():
        out.append(remove_tails_indices(np.arange(b, e), tail))
    return np.concatenate(out) if out else np.zeros((0,), np.int64)
