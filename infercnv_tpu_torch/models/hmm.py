"""HMM parameters for the i6 and i3 CNV-state models, their calibration
from the hspike, and the Viterbi drivers.

Copied from infercnv_tpu/models/hmm.py (plain numpy and scipy): the state
levels and proxy values (lines 35-39), the hspike statistics
``gene_expr_by_cnv`` and ``get_spike_dists`` (:46-69), ``HMMParams`` and
``state_emission_sds`` (:102-138), the i6 and i3 parameterisations
(:141-191), ``viterbi_per_group`` with its packed implementation (:331-386,
here over ops/viterbi_pack.py and the CUDA Viterbi), ``GroupedStates``,
the prediction entry points ``predict_hmm_on_cells``,
``predict_hmm_on_groups`` and ``predict_hmm_on_subclusters_per_chr``
(:414-543), and the proxy-value maps
(:545-561).  ``viterbi_per_group(impl="perchr")`` is the reference's
per-chromosome padding (``pack_by_chromosome``, :253-278, copied) run
through the same Viterbi kernel with each chromosome a sequence of its own
length.  ``cnv_mean_sd_trend_fit`` (:72-99) bootstraps with a
``torch.Generator`` on the CPU where the reference draws with
``jax.random``, so its fits agree with the reference's to the bootstrap's
spread.  With ``mesh=CellMesh`` the rows of ``viterbi_per_group`` (and so
of the cell and group drivers) are padded with ones to a multiple of the
shard count, split over the shards and run on each shard's device, then
gathered (:331-384).

reference: R/inferCNV_HMM.R — i6 states <-> CNV levels {0, 0.5, 1, 1.5, 2, 3};
R/inferCNV_i3HMM.R — i3 states {del, neutral, amp}; Viterbi.dthmm.adj
(:1101-1176) collapses the state sds to their median.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from infercnv_tpu_torch.core.genome import GeneOrder
from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.utils.logging import log_info
from infercnv_tpu_torch.utils.memmap import gather_rows

I6_LEVELS = ("cnv:0.01", "cnv:0.5", "cnv:1", "cnv:1.5", "cnv:2", "cnv:3")
I6_PROXY_VALUES = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0])
I3_PROXY_VALUES = np.array([0.5, 1.0, 1.5])
NEUTRAL_STATE_I6 = 3  # 1-based, as reported
NEUTRAL_STATE_I3 = 2


# ---------------------------------------------------------------------------
# emission calibration from the hspike
# ---------------------------------------------------------------------------

def gene_expr_by_cnv(hspike) -> Dict[str, np.ndarray]:
    """Residual expr values of hspike *tumor* cells pooled per CNV level
    (reference .get_gene_expr_by_cnv :45-68)."""
    from infercnv_tpu_torch.models.hspike import HSPIKE_GENES_PER_CHR, hspike_chr_info

    info = hspike_chr_info(HSPIKE_GENES_PER_CHR, 1)
    spike_idx = hspike.all_obs_idx()
    expr = hspike.expr[spike_idx]  # [C_spike, G]
    by_cnv: Dict[str, List[np.ndarray]] = {}
    for (name, cnv, _n) in info:
        key = f"cnv:{cnv:g}"
        if name not in hspike.gene_order.chr_names:
            continue
        gidx = hspike.gene_order.chr_gene_indices(name)
        if gidx.size == 0:
            continue
        by_cnv.setdefault(key, []).append(expr[:, gidx].ravel())
    return {k: np.concatenate(v) for k, v in by_cnv.items()}


def get_spike_dists(hspike) -> Dict[str, Tuple[float, float]]:
    """{cnv_level: (mean, sd)} (reference get_spike_dists :15-31; sd ddof=1)."""
    out = {}
    for k, vals in gene_expr_by_cnv(hspike).items():
        out[k] = (float(vals.mean()), float(vals.std(ddof=1)))
    return out


def cnv_mean_sd_trend_fit(hspike, seed: int = 777, nrounds: int = 100,
                          max_cells: int = 100) -> Dict[str, Tuple[float, float]]:
    """Per CNV level, fit log(sd of n-cell means) ~ log(n); returns
    {level: (intercept, slope)}.

    reference get_hspike_cnv_mean_sd_trend_by_num_cells_fit (:154-212):
    bootstrap-sample n values, sd over 100 replicates, for n = 1..100, then
    lm(log(sd) ~ log(n)).  As in the JAX package, the bootstrap is one
    [nrounds, max_cells] draw per level whose prefix means give every n at
    once; the draws come from a CPU ``torch.Generator`` seeded with `seed`.
    """
    gen = torch.Generator().manual_seed(int(seed))
    fits: Dict[str, Tuple[float, float]] = {}
    logn = np.log(np.arange(1, max_cells + 1))
    X = np.stack([np.ones_like(logn), logn], axis=1)
    steps = torch.arange(1, max_cells + 1, dtype=torch.float32)
    for lvl, vals in gene_expr_by_cnv(hspike).items():
        v = torch.as_tensor(np.asarray(vals, np.float32))
        idx = torch.randint(0, v.shape[0], (nrounds, max_cells), generator=gen)
        prefix_means = torch.cumsum(v[idx], dim=1) / steps   # [rounds, n]
        sds = prefix_means.std(dim=0, correction=1).numpy()  # [n]
        y = np.log(np.maximum(sds, 1e-12))
        beta, *_ = np.linalg.lstsq(X, y, rcond=None)
        fits[lvl] = (float(beta[0]), float(beta[1]))
    return fits


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


def pack_by_chromosome(x_bg: np.ndarray, gene_order: GeneOrder):
    """Pack [B, G] data into per-chromosome padded sequences.

    Returns (x_packed [B*n_chr, Lmax], mask [B*n_chr, Lmax], chr_ranges)."""
    ranges = [r for r in gene_order.chr_ranges() if r[1] > r[0]]
    Lmax = max(e - b for (b, e) in ranges)
    B = x_bg.shape[0]
    n_chr = len(ranges)
    xp = np.zeros((B, n_chr, Lmax), np.float32)
    mask = np.zeros((n_chr, Lmax), bool)
    for ci, (b, e) in enumerate(ranges):
        xp[:, ci, : e - b] = x_bg[:, b:e]
        mask[ci, : e - b] = True
    return (
        xp.reshape(B * n_chr, Lmax),
        np.broadcast_to(mask[None], (B, n_chr, Lmax)).reshape(B * n_chr, Lmax).copy(),
        ranges,
    )


def _viterbi_perchr(x_bg: np.ndarray, gene_order: GeneOrder, params: HMMParams,
                    sigma_rows: np.ndarray, dev: torch.device) -> np.ndarray:
    """impl='perchr': one padded sequence a (row, chromosome), each of its
    chromosome's length, through the Viterbi kernel with no restarts."""
    from infercnv_tpu_torch.ops.viterbi_kernel import transition_logs, viterbi

    B, G = x_bg.shape
    S = params.num_states
    xp, mask, ranges = pack_by_chromosome(x_bg, gene_order)
    n_chr = len(ranges)
    log_diag, log_off, log_delta = transition_logs(S, params.t)
    states = viterbi(
        torch.as_tensor(xp).to(dev),
        torch.as_tensor(mask.sum(axis=1).astype(np.int32)).to(dev),
        torch.as_tensor(np.repeat(sigma_rows, n_chr).astype(np.float32)).to(dev),
        torch.zeros(xp.shape, dtype=torch.int8, device=dev),
        np.asarray(params.means, np.float32), log_delta, log_diag, log_off)
    states = states.cpu().numpy().reshape(B, n_chr, -1)
    out = np.full((B, G), (S - 1) // 2 + 1, np.int32)  # neutral default
    for ci, (b, e) in enumerate(ranges):
        if e - b < 2:
            continue  # stays neutral
        out[:, b:e] = states[:, ci, :e - b]
    return out


def viterbi_per_group(x_bg, gene_order, params: HMMParams,
                      group_sds: Optional[np.ndarray] = None,
                      impl: str = "packed",
                      mesh=None, *,
                      device: DeviceLike = None) -> np.ndarray:
    """Viterbi for each row of x_bg ([B, G] per-cell or per-group mean
    expression), per chromosome.  group_sds: optional [B, S] per-row state
    sds, collapsed to their median (:1122); defaults to params.sds for every
    row.  Runs on ``device`` (CUDA unless the caller passes "cpu").

    impl='packed' (default): the bin-packed layout the streaming engine also
    runs (ops/viterbi_pack.py: chromosomes first-fit packed into bins with
    chain restarts).  impl='perchr': each chromosome its own padded
    sequence, the reference's cross-check; both give the same states.  With
    a mesh (parallel/stats.CellMesh; not with a device) the packed rows are
    padded with ones to a multiple of its shard count and each shard runs on
    its own device; the padded rows are independent sequences, dropped.

    Returns the 1-based state matrix [B, G] (int32).  Chromosomes with < 2
    genes get the neutral state (reference Viterbi.dthmm.adj :1104-1107)."""
    from infercnv_tpu_torch.ops.viterbi_pack import get_layout, viterbi_packed

    if impl not in ("packed", "perchr"):
        raise ValueError(f"unknown Viterbi impl {impl!r} (use 'packed' or 'perchr')")
    if mesh is not None and (device is not None or impl != "packed"):
        raise ValueError("a mesh runs the packed Viterbi on its own devices")
    if torch.is_tensor(x_bg):
        x_bg = x_bg.detach().cpu().numpy()
    B, G = x_bg.shape
    S = params.num_states
    if group_sds is None:
        group_sds = np.broadcast_to(params.sds[None, :], (B, S))
    sigma_rows = np.median(group_sds, axis=1)  # median collapse (:1122)
    x = np.asarray(x_bg, np.float32)
    sig = sigma_rows.astype(np.float32)
    if mesh is not None:
        from infercnv_tpu_torch.parallel.stats import (
            CellSharded,
            put_cell_sharded,
            to_host,
        )

        pad = -B % mesh.n_shards
        if pad:
            x = np.concatenate([x, np.ones((pad, G), np.float32)])
            sig = np.concatenate([sig, np.ones(pad, np.float32)])
        xs, ss = put_cell_sharded(x, mesh), put_cell_sharded(sig, mesh)
        layout = get_layout(gene_order)
        means = np.asarray(params.means, np.float32)
        states = CellSharded([viterbi_packed(xi, layout, means, si, params.t)
                              for xi, si in zip(xs.shards, ss.shards)], mesh)
        return to_host(states).astype(np.int32)[:B]
    dev = resolve_device(device)
    if impl == "perchr":
        return _viterbi_perchr(x, gene_order, params, sigma_rows, dev)
    states = viterbi_packed(
        torch.as_tensor(x).to(dev), get_layout(gene_order),
        np.asarray(params.means, np.float32), torch.as_tensor(sig).to(dev),
        params.t)
    return states.cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# prediction drivers (cell / subcluster / sample modes)
# ---------------------------------------------------------------------------

def _group_mean_rows(expr_cg: np.ndarray, groups: Dict[str, np.ndarray]
                     ) -> Tuple[np.ndarray, List[str], List[np.ndarray]]:
    names = list(groups.keys())
    idxs = [np.asarray(groups[n]) for n in names]
    # a disk memmap's rows are read through its file (utils/memmap.py)
    rows = np.stack([gather_rows(expr_cg, ix).mean(axis=0) for ix in idxs])
    return rows, names, idxs


@dataclasses.dataclass
class GroupedStates:
    """Factorized HMM state calls: one state row per group plus a cell->row
    map (group-mode calls are constant across a group's cells, so the
    [C, G] matrix is redundant; the region reports read this form)."""

    rows: np.ndarray          # [K, G] int8, 1-based states
    cell_to_row: np.ndarray   # [C] int32
    names: List[str]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.cell_to_row.shape[0], self.rows.shape[1])

    def materialize(self) -> np.ndarray:
        """Expand to the classic [C, G] matrix (one gather)."""
        return self.rows[self.cell_to_row]


def predict_hmm_on_cells(obj, params: HMMParams, mesh=None, *,
                         device: DeviceLike = None) -> np.ndarray:
    """Per-cell i6/i3 state matrix [C, G] int8
    (reference predict_CNV_via_HMM_on_indiv_cells :284-324); with a mesh
    the cells shard over it."""
    log_info("predict_hmm_on_cells()")
    return np.asarray(
        viterbi_per_group(obj.expr, obj.gene_order, params, device=device,
                          mesh=mesh),
        np.int8)


def predict_hmm_on_groups(
    obj,
    params: HMMParams,
    groups: Dict[str, np.ndarray],
    trend_fits: Optional[Dict[str, Tuple[float, float]]] = None,
    levels: Sequence[str] = I6_LEVELS,
    mesh=None,
    factorized: bool = False,
    *,
    device: DeviceLike = None,
):
    """Viterbi on per-group mean expression, states written back to every
    member cell (reference predict_CNV_via_HMM_on_tumor_subclusters :345-408
    / ..._whole_tumor_samples :509-567).  With trend_fits, per-group state
    sds follow the cell-count trend (.get_state_emission_params).  The
    group means are numpy means of the f32 rows, as the reference takes
    them.  factorized=True returns :class:`GroupedStates`.  With a mesh the
    group rows shard over it."""
    log_info(f"predict_hmm_on_groups() over {len(groups)} groups")
    rows, names, idxs = _group_mean_rows(obj.expr, groups)
    if trend_fits is not None:
        group_sds = np.stack([
            state_emission_sds(len(ix), trend_fits, levels) for ix in idxs
        ])
    else:
        group_sds = None
    states_rows = np.asarray(
        viterbi_per_group(rows, obj.gene_order, params, group_sds,
                          device=device, mesh=mesh),
        np.int8)
    neutral = (params.num_states - 1) // 2 + 1
    # cells outside every group (none in practice) keep the neutral row
    K = states_rows.shape[0]
    cell_to_row = np.full(obj.num_cells, K, np.int32)
    for r, ix in enumerate(idxs):
        cell_to_row[ix] = r
    if (cell_to_row == K).any():
        states_rows = np.concatenate(
            [states_rows, np.full((1, states_rows.shape[1]), neutral, np.int8)])
    gs = GroupedStates(rows=states_rows, cell_to_row=cell_to_row, names=names)
    return gs if factorized else gs.materialize()


def predict_hmm_on_subclusters_per_chr(
    obj,
    params: HMMParams,
    subclusters_per_chr: Dict[str, Dict[str, np.ndarray]],
    trend_fits: Optional[Dict[str, Tuple[float, float]]] = None,
    levels: Sequence[str] = I6_LEVELS,
    device: DeviceLike = None,
) -> np.ndarray:
    """Per-chromosome subcluster HMM (reference
    predict_CNV_via_HMM_on_tumor_subclusters_per_chr :412-487): each
    chromosome is predicted with its own cell partition, then the top-level
    subclusters force a per-region consensus.  Returns int8 [C, G]."""
    from infercnv_tpu_torch.report.regions import get_predicted_cnv_regions

    log_info("predict_hmm_on_subclusters_per_chr()")
    S = params.num_states
    out = np.full(obj.expr.shape, (S - 1) // 2 + 1, np.int8)
    for cname in obj.gene_order.chr_names:
        if cname not in subclusters_per_chr:
            continue
        gsel = obj.gene_order.chr_gene_indices(cname)
        if gsel.size < 2:
            continue
        sub_go = GeneOrder(
            names=tuple(obj.gene_order.names[i] for i in gsel),
            chr_names=(cname,),
            chr_ids=np.zeros(gsel.size, np.int32),
            start=obj.gene_order.start[gsel],
            stop=obj.gene_order.stop[gsel],
        )
        groups = subclusters_per_chr[cname]
        idxs = [np.asarray(v) for v in groups.values()]
        rows = np.stack([obj.expr[np.ix_(ix, gsel)].mean(axis=0) for ix in idxs])
        if trend_fits is not None:
            group_sds = np.stack([
                state_emission_sds(len(ix), trend_fits, levels) for ix in idxs])
        else:
            group_sds = None
        st = viterbi_per_group(rows, sub_go, params, group_sds, device=device)
        for r, ix in enumerate(idxs):
            out[np.ix_(ix, gsel)] = st[r]
    # force consensus per top-level subcluster region (reference :469-485)
    cell_lut = {n: i for i, n in enumerate(obj.cell_names)}
    gene_lut = {n: i for i, n in enumerate(obj.gene_order.names)}
    regions = get_predicted_cnv_regions(obj, out, by="subcluster")
    for gr in regions:
        cell_idx = np.array([cell_lut[c] for c in gr.cells], np.int64)
        for r in gr.regions:
            gidx = [gene_lut[g] for g in r.genes]
            out[np.ix_(cell_idx, gidx)] = r.state
    return out


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
