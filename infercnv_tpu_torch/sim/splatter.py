"""Splatter-style count simulation ('splatter' sim_method, experimental).

Counterpart of infercnv_tpu/sim/splatter.py.  ``SplatterParams``,
``_winsorize`` and ``estimate_splatter_params`` (lines 28-140, host numpy
and scipy) are copies.  ``simulate_splatter_counts`` draws on the device of
an explicit ``torch.Generator``: the reference splits its ``jax.random`` key
into seven (:144); here seven independent generators on the same device are
seeded from the caller's, one a draw (library sizes, outlier selection,
outlier factors, the BCV chi-square, the gamma draws, Poisson, dropout).
The gamma and chi-square draws take sim/meanvar.py's Marsaglia-Tsang gamma
on the generator's own normals and uniforms (``torch._standard_gamma`` and
``torch.distributions`` draw from the global stream and ignore a
generator); a chi-square of df degrees is 2 * Gamma(df / 2).  torch cannot
repeat jax.random's bits, so the counts agree with the reference's in
distribution only.

reference: R/SplatterScrape.R (:17-495) — the vendored Splatter
(Zappia, Phipson & Oshlack 2017) estimation/simulation routines:
gamma gene means (winsorized CvM/MME fit), (log)normal library sizes with a
normality test, lognormal expression outliers, BCV via common dispersion
with a chi-square df draw, Poisson counts on gamma-perturbed cell means,
and logistic/spline dropout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from scipy import optimize, stats

from infercnv_tpu_torch.ops.median import row_median_plain
from infercnv_tpu_torch.sim.meanvar import interp, standard_gamma
from infercnv_tpu_torch.utils.logging import log_warn
from infercnv_tpu_torch.utils.splines import SmoothingSpline, fit_smoothing_spline


@dataclasses.dataclass
class SplatterParams:
    mean_shape: float = 0.6
    mean_rate: float = 0.3
    lib_loc: float = 11.0
    lib_scale: float = 0.2
    lib_norm: bool = False
    out_prob: float = 0.05
    out_facLoc: float = 4.0
    out_facScale: float = 0.5
    bcv_common: float = 0.1
    bcv_df: float = 60.0
    dropout_mid: float = 0.0
    dropout_shape: float = -1.0
    dropout_spline: Optional[SmoothingSpline] = None
    include_dropout: bool = False
    use_spline_dropout_fit: bool = False
    nGenes: int = 0
    nCells: int = 0


def _winsorize(x: np.ndarray, q: float) -> np.ndarray:
    lo, hi = np.quantile(x, [q, 1 - q])
    return np.clip(x, min(lo, hi), max(lo, hi))


def estimate_splatter_params(counts_gc: np.ndarray,
                             include_dropout: bool = False,
                             use_spline_dropout_fit: bool = False) -> SplatterParams:
    """counts_gc: [G, C] raw counts (reference orientation).
    reference .estimateSingleCellParamsSplatterScrape (:17-51)."""
    p = SplatterParams(include_dropout=include_dropout,
                       use_spline_dropout_fit=use_spline_dropout_fit)
    counts_gc = np.asarray(counts_gc, np.float64)
    lib_sizes = counts_gc.sum(axis=0)
    lib_med = np.median(lib_sizes)
    # one all-zero cell would make every normalized value NaN (0/0) and
    # poison each estimated parameter downstream
    norm = counts_gc / np.maximum(lib_sizes, 1.0)[None, :] * lib_med
    norm = norm[(norm > 0).sum(axis=1) > 1]

    # gamma fit of winsorized means (.splatEstMean :53-74); scipy MLE ~ the
    # reference's CvM/MME fallbacks for these well-behaved summaries
    means = norm.mean(axis=1)
    means = _winsorize(means[means != 0], 0.1)
    try:
        shape, _loc, scale = stats.gamma.fit(means, floc=0)
        p.mean_shape, p.mean_rate = float(shape), float(1.0 / scale)
    except Exception:
        m, v = means.mean(), means.var()
        p.mean_shape, p.mean_rate = m * m / v, m / v

    # library sizes (.splatEstLib :90-124): Shapiro normality gate
    samp = lib_sizes if lib_sizes.size <= 5000 else \
        np.random.default_rng(0).choice(lib_sizes, 5000, replace=False)
    try:
        p_norm = stats.shapiro(samp).pvalue
    except Exception:
        p_norm = 0.0
    p.lib_norm = bool(p_norm > 0.2)
    if p.lib_norm:
        # fit on ALL library sizes; the 5000-cell subsample exists only for
        # the Shapiro test (reference .splatEstLib does the same)
        p.lib_loc, p.lib_scale = float(lib_sizes.mean()), \
            float(lib_sizes.std(ddof=1))
        log_warn("library sizes found normally distributed instead of log-normal")
    else:
        logs = np.log(lib_sizes[lib_sizes > 0])
        p.lib_loc, p.lib_scale = float(logs.mean()), float(logs.std(ddof=1))

    # outliers (.splatEstOutlier :126-152)
    gm = norm.mean(axis=1)
    lmeans = np.log(gm[gm > 0])
    med = np.median(lmeans)
    mad = stats.median_abs_deviation(lmeans, scale="normal")
    outs = lmeans > med + 2 * mad
    p.out_prob = float(outs.mean())
    if outs.sum() > 1:
        facs = np.log(gm[gm > 0][outs] / np.median(gm))
        p.out_facLoc, p.out_facScale = float(facs.mean()), float(max(facs.std(ddof=1), 1e-3))

    # BCV (.splatEstBCV :154-167): edgeR common dispersion approximated by a
    # moment estimate of the NB dispersion on depth-normalized counts
    m = norm.mean(axis=1)
    v = norm.var(axis=1, ddof=1)
    ok = m > 0
    disp = np.maximum((v[ok] - m[ok]) / np.maximum(m[ok] ** 2, 1e-12), 0.0)
    common_dispersion = float(np.median(disp[np.isfinite(disp)])) if ok.any() else 0.1
    p.bcv_common = 0.1 + 0.25 * common_dispersion
    p.bcv_df = 60.0  # reference uses edgeR prior.df (default 60)

    # dropout (.splatEstDropout :169-207)
    x = np.log(np.maximum(norm.mean(axis=1), 1e-12))
    y = (norm == 0).mean(axis=1)
    mid_guess = np.median(x[(y > 0.2) & (y < 0.8)]) if ((y > 0.2) & (y < 0.8)).any() else 0.0
    try:
        popt, _ = optimize.curve_fit(
            lambda xx, x0, k: 1.0 / (1.0 + np.exp(-k * (xx - x0))),
            x, y, p0=[mid_guess, -1.0], maxfev=5000)
        p.dropout_mid, p.dropout_shape = float(popt[0]), float(popt[1])
    except Exception:
        p.dropout_mid, p.dropout_shape = float(mid_guess), -1.0
    p.dropout_spline = fit_smoothing_spline(x, y)

    p.nGenes, p.nCells = counts_gc.shape
    return p


def _substreams(gen: torch.Generator, n: int):
    """n independent generators on gen's device, seeded from gen."""
    seeds = torch.randint(0, 2**62, (n,), generator=gen, device=gen.device)
    return [torch.Generator(device=gen.device).manual_seed(int(s))
            for s in seeds.tolist()]


def simulate_splatter_counts(gen: torch.Generator, params: SplatterParams,
                             gene_means: Optional[np.ndarray] = None,
                             num_cells: Optional[int] = None) -> torch.Tensor:
    """Simulate a [num_cells, G] counts matrix (float32, on the generator's
    device) (reference .simulateSingleCellCountsMatrixSplatterScrape
    :221-268 and the .splatSim* chain :270-495; infercnv_tpu/sim/splatter.py
    :143-192)."""
    nG = params.nGenes if gene_means is None else int(np.asarray(gene_means).shape[0])
    nC = int(num_cells or params.nCells)
    dev = gen.device
    g_lib, g_out1, g_out2, g_chi, g_gam, g_pois, g_drop = _substreams(gen, 7)

    # library sizes (.splatSimLibSizes)
    z = torch.randn((nC,), generator=g_lib, device=dev)
    if params.lib_norm:
        libs = params.lib_loc + params.lib_scale * z
        pos_min = torch.where(libs > 0, libs, torch.full_like(libs, float("inf"))).min()
        libs = torch.where(libs < 0, pos_min / 2, libs)
    else:
        libs = torch.exp(params.lib_loc + params.lib_scale * z)

    # gene means + outliers (.splatSimGeneMeans / .getLNormFactors)
    if gene_means is not None:
        base = torch.as_tensor(np.asarray(gene_means, np.float32), device=dev)
    else:
        base = standard_gamma(g_gam, params.mean_shape, (nG,)) / params.mean_rate
    sel = torch.bernoulli(torch.full((nG,), float(params.out_prob), device=dev),
                          generator=g_out1) > 0
    facs = torch.exp(params.out_facLoc + params.out_facScale *
                     torch.randn((nG,), generator=g_out2, device=dev))
    med = row_median_plain(base)
    means_gene = torch.where(sel, med * facs, base)

    # per-cell proportional means scaled to library size (.splatSimSingleCellMeans)
    props = means_gene / means_gene.sum()
    base_cell_means = props[None, :] * libs[:, None]          # [C, G]

    # BCV perturbation (.splatSimBCVMeans): chi-square(df) = 2 Gamma(df / 2)
    chi = 2.0 * standard_gamma(g_chi, params.bcv_df / 2.0, (nG,))
    bcv = (params.bcv_common
           + 1.0 / torch.sqrt(torch.clamp(base_cell_means, min=1e-8))) \
        * torch.sqrt(params.bcv_df / chi)[None, :]
    shape = 1.0 / (bcv ** 2)
    # the gamma stream goes on past the base means' draw: a stateful
    # generator never repeats them (the reference folds its key instead)
    cell_means = standard_gamma(g_gam, shape, shape.shape) * (base_cell_means * bcv ** 2)

    counts = torch.poisson(cell_means, generator=g_pois)

    # dropout (.splatSimDropout)
    if params.include_dropout:
        eta = torch.log(torch.clamp(cell_means, min=1e-12))
        if params.use_spline_dropout_fit and params.dropout_spline is not None:
            gx, gy = params.dropout_spline.dense_grid()
            prob = torch.clamp(interp(eta, gx, gy), 0.0, 1.0)
        else:
            prob = 1.0 / (1.0 + torch.exp(-params.dropout_shape
                                          * (eta - params.dropout_mid)))
        keep = torch.bernoulli(1.0 - prob, generator=g_drop)
        counts = counts * keep
    return counts
