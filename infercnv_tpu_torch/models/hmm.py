"""HMM parameters for the i6 and i3 CNV-state models, and the per-group
Viterbi (partial port).

Copied from infercnv_tpu/models/hmm.py (plain numpy and scipy): the state
levels and proxy values (lines 35-39), ``HMMParams`` and
``state_emission_sds`` (:102-138), the i6 and i3 parameterisations
(:141-191), ``viterbi_per_group`` with its packed implementation (:331-386,
here over ops/viterbi_pack.py and the CUDA Viterbi) and the proxy-value maps
(:545-561).  Not ported yet: the hspike statistics (``get_spike_dists``,
``cnv_mean_sd_trend_fit``), ``impl="perchr"`` and the ``predict_hmm_*``
drivers, which need ``InferCNV``.

reference: R/inferCNV_HMM.R — i6 states <-> CNV levels {0, 0.5, 1, 1.5, 2, 3};
R/inferCNV_i3HMM.R — i3 states {del, neutral, amp}; Viterbi.dthmm.adj
(:1101-1176) collapses the state sds to their median.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from infercnv_tpu_torch.device import DeviceLike, resolve_device

I6_LEVELS = ("cnv:0.01", "cnv:0.5", "cnv:1", "cnv:1.5", "cnv:2", "cnv:3")
I6_PROXY_VALUES = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0])
I3_PROXY_VALUES = np.array([0.5, 1.0, 1.5])
NEUTRAL_STATE_I6 = 3  # 1-based, as reported
NEUTRAL_STATE_I3 = 2


def state_emission_sds(num_cells: int, trend_fits: Dict[str, Tuple[float, float]],
                       levels: Sequence[str] = I6_LEVELS) -> np.ndarray:
    """sd per state for a group of `num_cells` cells
    (reference .get_state_emission_params :586-614: exp(lm predict))."""
    return np.array([
        np.exp(trend_fits[lvl][0] + trend_fits[lvl][1] * np.log(num_cells))
        for lvl in levels
    ])


@dataclasses.dataclass(frozen=True)
class HMMParams:
    means: np.ndarray    # [S] state emission means
    sds: np.ndarray      # [S] state emission sds (pre median-collapse)
    t: float             # off-diagonal transition probability

    @property
    def num_states(self) -> int:
        return self.means.shape[0]

    def delta(self) -> np.ndarray:
        """Start distribution: neutral-favoring (reference .get_HMM :230-265
        i6; .i3HMM_get_HMM i3HMM.R:99-156)."""
        S = self.num_states
        d = np.full(S, self.t)
        d[(S - 1) // 2] = 1.0 - (S - 1) * self.t
        return d

    def log_pi(self) -> np.ndarray:
        S = self.num_states
        P = np.full((S, S), self.t)
        np.fill_diagonal(P, 1.0 - (S - 1) * self.t)
        return np.log(P)


def i6_hmm_params(cnv_mean_sd: Dict[str, Tuple[float, float]], t: float = 1e-6) -> HMMParams:
    means = np.array([cnv_mean_sd[lvl][0] for lvl in I6_LEVELS])
    sds = np.array([cnv_mean_sd[lvl][1] for lvl in I6_LEVELS])
    return HMMParams(means=means, sds=sds, t=t)


def determine_mean_delta_via_Z(sigma: float, p: float = 0.05) -> float:
    """|qnorm(p, sd=sigma)| (reference i3HMM.R:435-445)."""
    from scipy.stats import norm
    return float(abs(norm.ppf(p, loc=0, scale=sigma)))


def honeybadger_setGexpDev(gexp_sd: float, alpha: float = 0.05, k_cells: int = 1) -> float:
    """HoneyBADGER-style KS deviation (reference get_HoneyBADGER_setGexpDev
    i3HMM.R:469-493), in closed form: dev = 2 sd qnorm(1 - alpha) / sqrt(k)
    (see the JAX package's honeybadger_setGexpDev for the derivation)."""
    from scipy.stats import norm
    return float(2.0 * gexp_sd * norm.ppf(1.0 - alpha) / np.sqrt(k_cells))


def i3_hmm_params(expr_cg, ref_groups: Sequence[np.ndarray],
                  obs_groups: Sequence[np.ndarray], t: float = 1e-6,
                  i3_p_val: float = 0.05, use_KS: bool = False) -> HMMParams:
    """i3 parameterization from normal-cell residuals
    (reference .i3HMM_get_sd_trend_by_num_cells_fit i3HMM.R:17-80 and
    .i3HMM_get_HMM :99-156): one constant sigma from the normal cells'
    residuals, mean_delta from qnorm (:435-445) or the HoneyBADGER KS fit
    with k_cells = the number of normal cells (:469-493); the reference's
    per-cell-count sigma trend is commented out there, so it is not used.
    expr_cg: [C, G] residuals, a numpy array or a tensor on any device."""
    if torch.is_tensor(expr_cg):
        expr_cg = expr_cg.detach().cpu().numpy()
    groups = ref_groups if len(ref_groups) > 0 else obs_groups
    idx = np.concatenate([np.asarray(g) for g in groups])
    vals = np.asarray(expr_cg)[idx]
    mu = float(vals.mean())
    sigma = float(vals.std(ddof=1))
    if use_KS:
        delta = honeybadger_setGexpDev(sigma, alpha=i3_p_val, k_cells=idx.size)
    else:
        delta = determine_mean_delta_via_Z(sigma, p=i3_p_val)
    means = np.array([mu - delta, mu, mu + delta])
    sds = np.array([sigma, sigma, sigma])
    return HMMParams(means=means, sds=sds, t=t)


def viterbi_per_group(x_bg, gene_order, params: HMMParams,
                      group_sds: Optional[np.ndarray] = None,
                      device: DeviceLike = None) -> np.ndarray:
    """Viterbi for each row of x_bg ([B, G] per-cell or per-group mean
    expression), per chromosome, over the bin-packed layout the streaming
    engine also runs (ops/viterbi_pack.py: chromosomes first-fit packed into
    bins with chain restarts).  group_sds: optional [B, S] per-row state sds,
    collapsed to their median (:1122); defaults to params.sds for every row.
    Runs on ``device`` (CUDA unless the caller passes "cpu").  The
    reference's impl="perchr" cross-check and its mesh argument are not
    ported.

    Returns the 1-based state matrix [B, G] (int32).  Chromosomes with < 2
    genes get the neutral state (reference Viterbi.dthmm.adj :1104-1107)."""
    from infercnv_tpu_torch.ops.viterbi_pack import get_layout, viterbi_packed

    dev = resolve_device(device)
    if torch.is_tensor(x_bg):
        x_bg = x_bg.detach().cpu().numpy()
    B = x_bg.shape[0]
    S = params.num_states
    if group_sds is None:
        group_sds = np.broadcast_to(params.sds[None, :], (B, S))
    sigma_rows = np.median(group_sds, axis=1)  # median collapse (:1122)
    states = viterbi_packed(
        torch.as_tensor(np.asarray(x_bg, np.float32)).to(dev),
        get_layout(gene_order), np.asarray(params.means, np.float32),
        torch.as_tensor(sigma_rows.astype(np.float32)).to(dev), params.t)
    return states.cpu().numpy().astype(np.int32)


def proxy_value_lut(num_states: int = 6) -> np.ndarray:
    """LUT indexed by the 1-based state value itself (lut[state] -> proxy
    level; lut[0] unused) — lets renderers map small state blocks to proxy
    values without materializing the [C, G] float matrix."""
    table = I6_PROXY_VALUES if num_states == 6 else I3_PROXY_VALUES
    return np.concatenate([[np.nan], table]).astype(np.float32)


def assign_states_to_proxy_values(states: np.ndarray, num_states: int = 6) -> np.ndarray:
    """State index (1-based) -> CNV proxy level
    (reference assign_HMM_states_to_proxy_expr_vals :1191-1206 i6,
    i3HMM.R:405-417 i3)."""
    table = I6_PROXY_VALUES if num_states == 6 else I3_PROXY_VALUES
    s = np.asarray(states)
    if s.dtype.kind not in "iu":  # float state matrices (old checkpoints)
        s = s.astype(np.int64)
    return table[s - 1].astype(np.float32)
