"""MCMC diagnostics of the Bayesian filter.

Copied from infercnv_tpu/viz/bayes_plots.py (``gelman_rubin``, line 196),
plain numpy: step 18 warns when the Gibbs chains mix poorly.  The plot
functions of that module are not ported yet (ROADMAP A7.3).
"""

from __future__ import annotations

import numpy as np


def gelman_rubin(traces: np.ndarray) -> np.ndarray:
    """R-hat per (region, state) from [chains, T, R, S] theta traces."""
    M, T = traces.shape[0], traces.shape[1]
    chain_means = traces.mean(axis=1)                 # [M, R, S]
    chain_vars = traces.var(axis=1, ddof=1)           # [M, R, S]
    W = chain_vars.mean(axis=0)
    B = T * chain_means.var(axis=0, ddof=1)
    var_hat = (T - 1) / T * W + B / T
    return np.sqrt(var_hat / np.maximum(W, 1e-12))
