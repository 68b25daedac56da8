"""Mean-variance-trend count simulation ('meanvar', the default sim_method)
and the negative-binomial 'simple' simulation.

Counterpart of infercnv_tpu/sim/meanvar.py.  The host statistics
(``group_stats_single_pass``, the mean-variance and dropout tables and their
splines, ``estimate_common_dispersion``) are copies of its numpy.  The two
simulators draw from a ``torch.Generator`` (the pipeline's lives on the CPU)
where the reference draws with ``jax.random``: torch cannot repeat those
bits, so the draws agree with the reference's in distribution only
(DESIGN.md section 9).  The gamma draws of 'simple' come from the
generator's own normals and uniforms (Marsaglia-Tsang), never from the
global stream.

reference: R/inferCNV_meanVarSim.R: a smoothing spline of
log(var+1) ~ log(mean+1) over all cell groups supplies the per-gene
variance; counts are round(max(N(m, sd), 0)); a per-gene dropout step then
matches the zero fraction predicted by a p0-vs-log(mean) spline
(.apply_dropout, meanVarSim.R:122-161).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from infercnv_tpu_torch.utils.splines import SmoothingSpline, fit_smoothing_spline


def group_stats_single_pass(expr_cg: np.ndarray,
                            group_sets: Sequence[Sequence[np.ndarray]],
                            chunk: int = 8192,
                            normalize_factor: float = None):
    """ONE chunked read pass over [C, G] computing, for every group of every
    group-set: per-gene (mean, var ddof=1, zero fraction), plus per-cell
    library sizes.

    Equivalent to the per-group gathers of get_mean_var_table /
    get_mean_vs_p0_table (reference meanVarSim.R:178-196,
    inferCNV_simple_sim.R:97-151) but without materializing any
    [group, G] copy — at 100k cells those gathers alone write ~7 GB.
    Within-chunk contractions run as float32 sgemms accumulated into
    float64 across chunks (matching the old per-group float32 np.var to
    ~1e-6 relative; the spline fits consuming these are insensitive at
    that scale).

    Returns ([(means [K,G], vars [K,G], p0 [K,G]) per set], libsizes [C]).
    """
    C, G = expr_cg.shape
    labelings = []
    for groups in group_sets:
        g_of = np.full(C, -1, np.int32)
        for k, idx in enumerate(groups):
            g_of[np.asarray(idx)] = k
        labelings.append((g_of, len(groups)))
    acc = [(np.zeros((K, G)), np.zeros((K, G)), np.zeros((K, G)))
           for (_g, K) in labelings]
    libsizes = np.empty(C, np.float64)
    # reused per-chunk buffers: the square and the zero-indicator are the
    # only full-width temporaries, written once per chunk
    blk2 = np.empty((min(chunk, C), G), np.float32)
    nzf = np.empty((min(chunk, C), G), np.float32)
    for b in range(0, C, chunk):
        blk = expr_cg[b:b + chunk]
        n = blk.shape[0]
        ls = blk.sum(axis=1, dtype=np.float64)
        libsizes[b:b + chunk] = ls
        if normalize_factor is not None:
            # stats of the depth-normalized matrix from RAW counts, without
            # ever materializing the normalized [C, G] matrix
            blk = blk * (normalize_factor /
                         np.maximum(ls, 1e-12))[:, None].astype(np.float32)
        np.multiply(blk, blk, out=blk2[:n])
        nzf[:n] = (blk == 0)
        for (g_of, K), (sums, sqs, zeros) in zip(labelings, acc):
            gids = g_of[b:b + chunk]
            # skinny one-hot sgemms: the chunk is READ three times, the
            # only writes are [K, G] accumulators (BLAS, not per-group
            # gather copies — those wrote a full matrix per group set)
            onehot = np.zeros((K, n), np.float32)
            valid = gids >= 0
            onehot[gids[valid], np.nonzero(valid)[0]] = 1.0
            sums += onehot @ blk
            sqs += onehot @ blk2[:n]
            zeros += onehot @ nzf[:n]
    out = []
    for (g_of, K), groups, (sums, sqs, zeros) in zip(labelings, group_sets, acc):
        ns = np.array([len(np.asarray(g)) for g in groups], np.float64)[:, None]
        means = sums / ns
        var = (sqs - ns * means * means) / np.maximum(ns - 1, 1)
        out.append((means, np.maximum(var, 0.0), zeros / ns))
    return out, libsizes


def get_mean_var_table(expr_cg: np.ndarray, groups: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Pooled per-group per-gene (mean, var) rows
    (reference .get_mean_var_table meanVarSim.R:178-196; var has ddof=1)."""
    ms, vs = [], []
    for idx in groups:
        sub = expr_cg[np.asarray(idx)]
        ms.append(sub.mean(axis=0))
        vs.append(sub.var(axis=0, ddof=1))
    return np.concatenate(ms), np.concatenate(vs)


def fit_mean_var_spline(m: np.ndarray, v: np.ndarray) -> SmoothingSpline:
    """smooth.spline(log(v+1) ~ log(m+1)) (reference meanVarSim.R:27-31)."""
    return fit_smoothing_spline(np.log(m + 1.0), np.log(v + 1.0))


def get_mean_vs_p0_table(expr_cg: np.ndarray, groups: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Pooled (gene mean, fraction of zeros) rows
    (reference .get_mean_vs_p0_table inferCNV_simple_sim.R:97-151)."""
    ms, p0s = [], []
    for idx in groups:
        sub = expr_cg[np.asarray(idx)]
        ms.append(sub.mean(axis=0))
        p0s.append((sub == 0).mean(axis=0))
    return np.concatenate(ms), np.concatenate(p0s)


def fit_dropout_spline(m: np.ndarray, p0: np.ndarray) -> SmoothingSpline:
    """smooth.spline(p0 ~ log(m)) on m>0 rows
    (reference .get_logistic_params inferCNV_simple_sim.R:188-225; the
    spline — not the nls logistic — is what .apply_dropout uses)."""
    ok = m > 0
    return fit_smoothing_spline(np.log(m[ok]), p0[ok])


def interp(x: torch.Tensor, xp: np.ndarray, fp: np.ndarray) -> torch.Tensor:
    """Piecewise-linear interpolation of (xp, fp) at x, in float32, with
    the end values held beyond the grid (as jnp.interp defines it)."""
    xp_t = torch.as_tensor(np.asarray(xp, np.float32), device=x.device)
    fp_t = torch.as_tensor(np.asarray(fp, np.float32), device=x.device)
    i = torch.searchsorted(xp_t, x.contiguous()).clamp(1, xp_t.shape[0] - 1)
    x0, x1 = xp_t[i - 1], xp_t[i]
    f0, f1 = fp_t[i - 1], fp_t[i]
    y = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    y = torch.where(x <= xp_t[0], fp_t[0], y)
    return torch.where(x >= xp_t[-1], fp_t[-1], y)


def simulate_meanvar_counts(
    gen: torch.Generator,
    gene_means: np.ndarray,
    mean_var_spline: SmoothingSpline,
    num_cells: int,
    dropout_spline: Optional[SmoothingSpline] = None,
) -> torch.Tensor:
    """Simulate a [num_cells, G] count matrix (float32, on the generator's
    device).

    reference .get_simulated_cell_matrix_using_meanvar_trend_helper
    (meanVarSim.R:23-57) + .sim_expr_val_mean_var_no_dropout (:105-119) +
    .apply_dropout (:122-161).
    """
    gene_means = np.asarray(gene_means, np.float64)
    G = gene_means.shape[0]
    pred_log_var = mean_var_spline.predict(np.log(gene_means + 1.0))
    var = np.maximum(np.exp(pred_log_var) - 1.0, 0.0)
    dev = gen.device
    sds = torch.as_tensor(np.sqrt(var).astype(np.float32), device=dev)
    means = torch.as_tensor(gene_means.astype(np.float32), device=dev)

    z = torch.randn((num_cells, G), generator=gen, device=dev)
    vals = torch.round(torch.clamp(means[None, :] + sds[None, :] * z, min=0.0))
    vals = torch.where(means[None, :] > 0, vals, torch.zeros_like(vals))

    if dropout_spline is not None:
        gx, gy = dropout_spline.dense_grid()
        row_means = vals.mean(dim=0)  # per-gene mean of simulated counts
        log_rm = torch.log(torch.clamp(row_means, min=1e-12))
        p0 = interp(log_rm, gx, gy)
        n_total = float(num_cells)
        n_zero = (vals == 0).sum(dim=0).to(torch.float32)
        n_remaining = n_total - n_zero
        padj = (p0 * n_total - n_zero) / torch.clamp(n_remaining, min=1.0)
        padj = torch.where(n_remaining > 0, torch.clamp(padj, min=0.0),
                           torch.zeros_like(padj))
        u = torch.rand((num_cells, G), generator=gen, device=dev)
        vals = torch.where(u <= padj[None, :], torch.zeros_like(vals), vals)
    return vals


def estimate_common_dispersion(counts_gc: np.ndarray,
                               grid: int = 60) -> float:
    """NB common-dispersion estimate from a genes x cells counts matrix.

    reference ``.estimate_common_dispersion`` (inferCNV_simple_sim.R:227-240)
    wraps ``edgeR::estimateDisp`` — but note that function is DEAD CODE in
    the reference: it is never called, and every ``.get_simulated_cell_matrix``
    call site hardcodes ``common_dispersion=0.1``
    (inferCNV_hidden_spike.R:86, :123, :258).  This equivalent (profile MLE
    of the shared NB dispersion with per-gene means on library-size
    normalized counts, the same estimand as edgeR's common qCML) is provided
    for API parity and for users who want a data-driven value to pass to
    ``simulate_simple_counts``.
    """
    from scipy.special import gammaln

    y = np.asarray(counts_gc, np.float64)
    # the likelihood surface of a SHARED dispersion is extremely stable
    # under subsampling; cap the matrix so the ~100 objective evaluations
    # below stay in seconds at 100k cells (deterministic strided sample)
    MAX_ELEMS = 20_000_000
    if y.size > MAX_ELEMS:
        step_g = max(1, int(np.ceil(y.shape[0] * y.shape[1] / MAX_ELEMS) ** 0.5))
        y = y[::step_g, ::step_g]
    libs = y.sum(axis=0)
    libs = np.where(libs > 0, libs, 1.0)
    # normalize to the mean library size (edgeR's equalizeLibSizes spirit)
    yn = y / libs[None, :] * libs.mean()
    mu = yn.mean(axis=1, keepdims=True)
    keep = mu[:, 0] > 0
    yn, mu = yn[keep], mu[keep]
    if yn.size == 0:
        return 0.1

    def negll(log_phi: float) -> float:
        phi = np.exp(log_phi)
        r = 1.0 / phi
        ll = (gammaln(yn + r) - gammaln(r) - gammaln(yn + 1.0)
              + r * np.log(r / (r + mu)) + yn * np.log(mu / (r + mu)))
        return -float(ll.sum())

    logs = np.linspace(np.log(1e-4), np.log(10.0), grid)
    vals = np.array([negll(lp) for lp in logs])
    i = int(vals.argmin())
    # golden-section refine around the grid minimum
    lo = logs[max(i - 1, 0)]
    hi = logs[min(i + 1, grid - 1)]
    gr = (np.sqrt(5) - 1) / 2
    a, b = lo, hi
    # standard golden-section: one NEW objective evaluation per iteration
    # (the discarded endpoint's value is reused)
    c = b - gr * (b - a)
    d = a + gr * (b - a)
    fc, fd = negll(c), negll(d)
    for _ in range(40):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = negll(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = negll(d)
    return float(np.exp((a + b) / 2))


def standard_gamma(gen: torch.Generator, shape, size) -> torch.Tensor:
    """Gamma(shape, 1) draws of the given size (float32) from the
    generator's normals and uniforms: Marsaglia and Tsang's squeeze method
    for shape >= 1, rejected draws redrawn until every entry is accepted;
    for shape < 1 a Gamma(shape + 1) draw times U^(1/shape).  ``shape`` is
    a number, or a tensor of ``size`` (one shape an entry)."""
    dev = gen.device
    alpha = torch.as_tensor(shape, dtype=torch.float32, device=dev).expand(size).reshape(-1)
    small = alpha < 1.0
    a = torch.where(small, alpha + 1.0, alpha)
    d_all = a - 1.0 / 3.0
    c_all = 1.0 / torch.sqrt(9.0 * d_all)
    out = torch.empty(alpha.shape, dtype=torch.float32, device=dev)
    todo = torch.arange(out.numel(), device=dev)
    while todo.numel():
        d, c = d_all[todo], c_all[todo]
        x = torch.randn(todo.numel(), generator=gen, device=dev)
        u = torch.rand(todo.numel(), generator=gen, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        out[todo[ok]] = (d * v)[ok]
        todo = todo[~ok]
    if bool(small.any()):
        u = torch.rand(out.shape, generator=gen, device=dev)
        out = torch.where(small, out * u ** (1.0 / alpha), out)
    return out.view(size)


def simulate_simple_counts(
    gen: torch.Generator,
    gene_means: np.ndarray,
    num_cells: int,
    common_dispersion: float = 0.1,
    dropout_spline: Optional[SmoothingSpline] = None,
) -> torch.Tensor:
    """Negative-binomial simulation ('simple' sim_method, experimental).

    reference .get_simulated_cell_matrix / .sim_expr_val
    (inferCNV_simple_sim.R:27-89): val ~ NB(mu=m, size=1/dispersion) as a
    gamma-Poisson mixture; per-value dropout with probability
    p0_spline(log(val))."""
    gene_means = np.asarray(gene_means, np.float64)
    G = gene_means.shape[0]
    dev = gen.device
    means = torch.as_tensor(gene_means.astype(np.float32), device=dev)
    size = 1.0 / common_dispersion
    lam = standard_gamma(gen, size, (num_cells, G)) * (means[None, :] / size)
    vals = torch.poisson(lam, generator=gen)
    vals = torch.where(means[None, :] > 0, vals, torch.zeros_like(vals))
    if dropout_spline is not None:
        gx, gy = dropout_spline.dense_grid()
        logv = torch.log(torch.clamp(vals, min=1e-12))
        p = interp(logv, gx, gy)
        u = torch.rand(vals.shape, generator=gen, device=dev)
        vals = torch.where((vals > 0) & (u <= p), torch.zeros_like(vals), vals)
    return vals
