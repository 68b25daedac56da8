"""Bayesian-filter visualization & MCMC diagnostics.

reference: R/inferCNV_BayesNet.R — plotProbabilities (:808-844: per-region
state-probability bars + per-cell probability bars), postProbNormal
(:757-788: heatmap overlay of 1 - P(normal) per CNV region), and
mcmcDiagnosticPlots (:866-990: trace / autocorrelation / Gelman-Rubin /
Geweke on the theta chains) — matplotlib equivalents.

Copied from infercnv_tpu/viz/bayes_plots.py (all of it: ``plot_cnv_probabilities``
:31, ``plot_cell_probabilities`` :77, ``post_prob_normal_heatmap`` :152,
``gelman_rubin`` :196, ``geweke_z`` :207, ``mcmc_diagnostic_plots`` :217),
host numpy and matplotlib on the port's ``BayesResult``, whose fields are the
same.  Two changes: ``post_prob_normal_heatmap`` takes ``timings`` (the
seconds of its painting, "data", and of its figure, "render"), and
``mcmc_diagnostic_plots`` writes ``MCMC_Diagnostics.txt`` before its figure,
which it does not depend on.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.models.bayes import BayesResult
from infercnv_tpu_torch.utils.logging import log_info


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_cnv_probabilities(result: BayesResult, out_dir: str,
                           output_filename: str = "cnvProbs") -> Optional[str]:
    """Stacked per-region state-probability bars (reference plot_cnv_prob).

    ALL regions are plotted (as the reference does); beyond 200 regions per
    figure the bars become unreadable and the canvas would exceed Agg's
    2^16-pixel limit, so additional pages are written as
    ``<name>.page2.png`` etc."""
    if result.cnv_state_probabilities is None or not result.cnv_region_names:
        return None
    plt = _mpl()
    probs = result.cnv_state_probabilities  # [S, R]
    S, R = probs.shape
    names = list(result.cnv_region_names)
    os.makedirs(out_dir, exist_ok=True)
    PER_PAGE = 200
    n_pages = -(-R // PER_PAGE)
    if n_pages > 1:
        log_info(f"-cnvProbs: {R} regions across {n_pages} pages")
    first_path = None
    cmap = plt.get_cmap("RdBu_r")
    for page in range(n_pages):
        sl = slice(page * PER_PAGE, min((page + 1) * PER_PAGE, R))
        p = probs[:, sl]
        nm = names[sl]
        n = p.shape[1]
        fig, ax = plt.subplots(figsize=(max(6, n * 0.25), 4))
        bottom = np.zeros(n)
        for s in range(S):
            ax.bar(np.arange(n), p[s], bottom=bottom,
                   color=cmap(s / max(S - 1, 1)), label=f"state {s+1}")
            bottom += p[s]
        ax.set_xticks(np.arange(n))
        ax.set_xticklabels(nm, rotation=90, fontsize=5)
        ax.set_ylabel("P(state)")
        ax.legend(fontsize=6, ncol=S)
        suffix = "" if page == 0 else f".page{page + 1}"
        path = os.path.join(out_dir, f"{output_filename}{suffix}.png")
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)
        log_info(f"-wrote {path}")
        first_path = first_path or path
    return first_path


def plot_cell_probabilities(result: BayesResult, out_dir: str,
                            output_filename: str = "cellProbs") -> Optional[str]:
    """Per-cell state-probability bars for each region (reference
    plot_cell_prob :1112-1135), one panel per region."""
    if not result.cell_probabilities:
        return None
    plt = _mpl()
    cell_probs = list(result.cell_probabilities)
    names = list(result.cnv_region_names)
    os.makedirs(out_dir, exist_ok=True)
    # ALL regions are plotted; 64 panels per page keeps each figure within
    # Agg's canvas limit, extra pages get a .pageN suffix
    PER_PAGE = 64
    n_pages = -(-len(cell_probs) // PER_PAGE)
    if n_pages > 1:
        log_info(f"-cellProbs: {len(cell_probs)} regions across "
                 f"{n_pages} pages")
    cmap = plt.get_cmap("RdBu_r")
    first_path = None
    for page in range(n_pages):
        cps = cell_probs[page * PER_PAGE:(page + 1) * PER_PAGE]
        nms = names[page * PER_PAGE:(page + 1) * PER_PAGE]
        n = len(cps)
        ncol = min(4, n)
        nrow = -(-n // ncol)
        big = n_pages > 1
        # multi-page mode: smaller panels, no tight_layout (it lays out
        # every axis twice and dominated wall-clock at 19 pages x 64
        # panels), lower dpi — same information, ~5x faster per page
        fig, axes = plt.subplots(
            nrow, ncol,
            figsize=((2.6 if big else 4) * ncol, (1.5 if big else 2.2) * nrow),
            squeeze=False)
        for ri, cp in enumerate(cps):
            ax = axes[ri // ncol][ri % ncol]
            S, C = cp.shape
            if C > 2000 or big:
                # a stacked area is visually identical to adjacent unit
                # bars and renders ~100x faster (one path per state
                # instead of C rectangles)
                cum = np.cumsum(cp, axis=0)
                xs = np.arange(C)
                prev = np.zeros(C)
                for s in range(S):
                    ax.fill_between(xs, prev, cum[s], step="mid",
                                    color=cmap(s / max(S - 1, 1)), lw=0)
                    prev = cum[s]
                ax.set_xlim(-0.5, max(C - 0.5, 0.5))
            else:
                bottom = np.zeros(C)
                for s in range(S):
                    ax.bar(np.arange(C), cp[s], bottom=bottom, width=1.0,
                           color=cmap(s / max(S - 1, 1)))
                    bottom += cp[s]
            ax.set_title(nms[ri], fontsize=6)
            ax.set_xticks([])
            if big:
                ax.set_yticks([])
        for k in range(n, nrow * ncol):
            axes[k // ncol][k % ncol].axis("off")
        suffix = "" if page == 0 else f".page{page + 1}"
        path = os.path.join(out_dir, f"{output_filename}{suffix}.png")
        if big:
            fig.subplots_adjust(hspace=0.8, wspace=0.15,
                                left=0.03, right=0.99, top=0.97, bottom=0.02)
            fig.savefig(path, dpi=110)
        else:
            fig.tight_layout()
            fig.savefig(path, dpi=150)
        plt.close(fig)
        log_info(f"-wrote {path}")
        first_path = first_path or path
    return first_path


def post_prob_normal_heatmap(obj: InferCNV, result: BayesResult,
                             regions: List[dict], out_dir: str,
                             output_filename: str = "infercnv.NormalProbabilities.PostFiltering",
                             timings: Optional[dict] = None):
    """Heatmap of 1 - P(normal) painted over each region's cells
    (reference postProbNormal :757-788).  `timings`, when given, receives
    the seconds of the painting ("data") and of the figure ("render")."""
    if result.cnv_state_probabilities is None:
        return None
    t0 = time.perf_counter()
    S = result.cnv_state_probabilities.shape[0]
    neutral = 3 if S == 6 else 2
    C, G = obj.expr.shape
    # paint straight into the DISPLAY raster: each region adds its
    # probability to the display bins its cells fall into, weighted by how
    # many of the bin's cells it covers — the exact mean-downsample of the
    # full [C, G] painting without ever allocating it (3.5 GB at 100k cells)
    n_bins = min(C, 4000)
    bin_of = (np.arange(C, dtype=np.int64) * n_bins) // C
    bin_count = np.bincount(bin_of, minlength=n_bins).astype(np.float32)
    mat = np.zeros((n_bins, G), np.float32)
    name_to_ri = {n: i for i, n in enumerate(result.cnv_region_names)}
    for r in regions:
        ri = name_to_ri.get(r["name"])
        if ri is None:
            continue
        p_not_normal = 1.0 - result.cnv_state_probabilities[neutral - 1, ri]
        cnt = np.bincount(bin_of[r["cell_idx"]], minlength=n_bins)
        touched = np.nonzero(cnt)[0]
        mat[np.ix_(touched, r["gene_idx"])] += (
            p_not_normal * cnt[touched] / bin_count[touched])[:, None]
    t1 = time.perf_counter()
    if timings is not None:
        timings["data"] = timings.get("data", 0.0) + t1 - t0
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 5))
    im = ax.imshow(mat, aspect="auto", cmap="viridis", vmin=0, vmax=1,
                   interpolation="nearest")
    fig.colorbar(im, ax=ax, label="1 - P(normal)")
    ax.set_xlabel("genes (genomic order)")
    ax.set_ylabel("cells")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{output_filename}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    if timings is not None:
        timings["render"] = timings.get("render", 0.0) + time.perf_counter() - t1
    log_info(f"-wrote {path}")
    return path


def gelman_rubin(traces: np.ndarray) -> np.ndarray:
    """R-hat per (region, state) from [chains, T, R, S] theta traces."""
    M, T = traces.shape[0], traces.shape[1]
    chain_means = traces.mean(axis=1)                 # [M, R, S]
    chain_vars = traces.var(axis=1, ddof=1)           # [M, R, S]
    W = chain_vars.mean(axis=0)
    B = T * chain_means.var(axis=0, ddof=1)
    var_hat = (T - 1) / T * W + B / T
    return np.sqrt(var_hat / np.maximum(W, 1e-12))


def geweke_z(traces: np.ndarray, first: float = 0.1, last: float = 0.5) -> np.ndarray:
    """Geweke z-score per (chain, region, state)."""
    T = traces.shape[1]
    a = traces[:, : int(T * first)]
    b = traces[:, -int(T * last):]
    num = a.mean(axis=1) - b.mean(axis=1)
    den = np.sqrt(a.var(axis=1, ddof=1) / a.shape[1] + b.var(axis=1, ddof=1) / b.shape[1])
    return num / np.maximum(den, 1e-12)


def mcmc_diagnostic_plots(result: BayesResult, out_dir: str,
                          max_regions: int = 6) -> Optional[str]:
    """Trace + autocorrelation panels for the first regions, plus a text
    summary of R-hat / Geweke (reference mcmcDiagnosticPlots :866-990)."""
    if result.theta_traces is None or not result.cnv_region_names:
        return None
    traces = result.theta_traces                      # [M, T, R, S]
    M, T, R, S = traces.shape
    os.makedirs(out_dir, exist_ok=True)
    rhat = gelman_rubin(traces)
    gz = geweke_z(traces)
    with open(os.path.join(out_dir, "MCMC_Diagnostics.txt"), "w") as f:
        f.write("region\tmax_Rhat\tmax_abs_geweke_z\n")
        for ri, name in enumerate(result.cnv_region_names):
            f.write(f"{name}\t{np.nanmax(rhat[ri]):.4f}\t"
                    f"{np.nanmax(np.abs(gz[:, ri])):.3f}\n")
    plt = _mpl()
    nshow = min(max_regions, R)
    fig, axes = plt.subplots(nshow, 2, figsize=(9, 2.0 * nshow), squeeze=False)
    for ri in range(nshow):
        ax_tr, ax_ac = axes[ri]
        for m in range(M):
            ax_tr.plot(traces[m, :, ri, :].max(axis=1), lw=0.5)
        ax_tr.set_title(f"{result.cnv_region_names[ri]} trace (max state P)", fontsize=6)
        x = traces[:, :, ri, :].mean(axis=(0, 2))
        x = x - x.mean()
        ac = np.correlate(x, x, mode="full")[x.size - 1:]
        ac = ac / max(ac[0], 1e-12)
        ax_ac.bar(np.arange(min(30, ac.size)), ac[:30], width=0.8)
        ax_ac.set_title("autocorrelation", fontsize=6)
    path = os.path.join(out_dir, "MCMC_Diagnostics.png")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    log_info(f"-wrote {path} and MCMC_Diagnostics.txt")
    return path
