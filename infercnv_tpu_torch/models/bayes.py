"""Bayesian mixture-model CNV filtering (steps 18-19).

Counterpart of infercnv_tpu/models/bayes.py (``BayesResult`` :52-60,
``_gibbs_all_regions`` :63-133, ``region_loglik`` :136-212,
``run_bayesian_mixture`` :215-347, ``remove_cells_filter`` :350-383,
``bayesian_filter_states`` :386-471 and the aliases :479-499).

reference: R/inferCNV_BayesNet.R + inst/BUGS_Mixture_Model{,_i3}.  Per
non-neutral CNV region r (from the step-17 HMM report), with cells j of the
region's cell group and genes i of the region:

    gexp[i, j] ~ N(mu[eps_j], tau[eps_j])      (tau = precision)
    eps_j      ~ Categorical(theta)
    theta      ~ Dirichlet(1, ..., 1)

(mu, tau) per state come from the hspike (i6) or the i3 trend.  This
conjugate pair has an exact blocked Gibbs sweep: eps | theta is categorical
with logits log(theta_s) + LL[j, s], theta | eps is Dirichlet(1 + counts).
Every (region x chain) pair of a block runs at once as [chains, R, Cmax, S]
tensors on the device, one Python loop over the sweeps with no host
synchronisation inside it.

On the device: the region log-likelihood (two ``torch.matmul`` products
streamed over cell chunks, the padded-group gather, the moment form) and
the sampler.  On the host, as in the reference: the region descriptors
(``report.regions.get_predicted_cnv_regions``), the blocking, the filter's
rewrites of the state matrix and ``CNV_State_Probabilities.dat``.

Random draws: block ``bi`` of a call with ``seed`` draws from its own
``torch.Generator`` on the tensors' device, seeded with
``numpy.random.SeedSequence([seed, bi]).generate_state(1, uint64)``;
removeCells' round k passes ``seed + k``, as the reference does.  The
draws differ from the JAX package's (threefry keys), and the card's
(Philox) from the CPU's (mt19937): the sampler is held to its posterior,
not draw for draw.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.models import hmm as hmm_mod
from infercnv_tpu_torch.report.regions import get_predicted_cnv_regions
from infercnv_tpu_torch.utils.logging import log_info, log_warn
from infercnv_tpu_torch.utils.memmap import gather_rows, read_rows

N_CHAINS_I6 = 6
N_CHAINS_I3 = 3
N_BURN = 200
N_ITER = 1000
# elements per Gumbel transient [chains, R_blk, Cmax_blk, S] (~1 GB f32);
# regions chunk into blocks under this (tests shrink it to force blocking)
_GIBBS_TRANSIENT_BUDGET = 256 * 1024 * 1024


class BayesResult:
    def __init__(self):
        self.cnv_region_names: List[str] = []
        self.cnv_state_probabilities: Optional[np.ndarray] = None  # [S, R]
        self.cell_probabilities: List[np.ndarray] = []             # per region [S, n_cells]
        self.removed_regions: List[str] = []
        self.reassigned: List[Tuple[str, int, int]] = []
        self.theta_traces: Optional[np.ndarray] = None  # [chains, T, R, S]
        self.regions: List[dict] = []  # region descriptors (modeled, pre-filter)
        # seconds of run_bayesian_mixture's parts (host clock; the device
        # parts end in a synchronise): regions, loglik, sampler
        self.seconds = {"regions": 0.0, "loglik": 0.0, "sampler": 0.0}
        self.sweeps = 0   # sampler sweeps run (blocks x (burn-in + iterations))


def block_generator(seed: int, block: int, device) -> torch.Generator:
    """The generator of region block `block` of a call with `seed`."""
    state = np.random.SeedSequence([int(seed), int(block)]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


def _gibbs_all_regions(gen: torch.Generator, loglik: torch.Tensor,
                       cell_mask: torch.Tensor, n_chains: int, n_burn: int,
                       n_iter: int, thin: int = 1):
    """Blocked Gibbs over all regions/chains at once.

    loglik: [R, Cmax, S] per-cell per-state log-likelihood (region gene
    sums) with each region's cell group padded to the widest group;
    cell_mask: [R, Cmax] membership (padded slots 0); both on gen's device.
    Returns (theta_mean [R, S], eps_freq [R, Cmax, S],
    traces [chains, n_iter // thin, R, S]) as tensors on that device.

    Memory design (the reference's): the state assignment is carried as
    integer draws [chains, R, Cmax] (not one-hot), the per-cell frequency
    accumulator eps_sum [R, Cmax, S] is shared across chains, and the only
    [chains, R, Cmax, S] tensors are the sweep's logits and Gumbel noise.
    """
    R, C, S = loglik.shape
    dev = loglik.device
    ll = loglik.to(torch.float32)
    m = cell_mask.to(torch.float32)
    T = n_burn + n_iter
    n_keep = n_iter // thin
    tiny = torch.finfo(torch.float32).tiny
    below_one = 1.0 - torch.finfo(torch.float32).eps / 2

    # JAGS-style dispersion: chain x starts every cell in state x mod S
    draw = (torch.arange(n_chains, device=dev) % S).view(n_chains, 1, 1)
    draw = draw.expand(n_chains, R, C).contiguous()
    m_ch = m.expand(n_chains, R, C)
    theta_sum = torch.zeros((n_chains, R, S), dtype=torch.float32, device=dev)
    eps_sum = torch.zeros((R, C, S), dtype=torch.float32, device=dev)
    ones = torch.ones((R, C, n_chains), dtype=torch.float32, device=dev)
    traces = torch.empty((n_keep, n_chains, R, S), dtype=torch.float32, device=dev)
    for it in range(T):
        # state counts per chain over the real cells: sum_j m[r,j] [draw==s]
        counts = torch.zeros((n_chains, R, S), dtype=torch.float32, device=dev)
        counts.scatter_add_(2, draw, m_ch)
        # theta ~ Dirichlet(counts + 1) as normalised Gamma draws
        g = torch._standard_gamma(counts + 1.0, generator=gen)
        theta = g / g.sum(dim=-1, keepdim=True)                   # [ch, R, S]
        # eps ~ Categorical(softmax(log theta + ll)) by Gumbel-max
        u = torch.rand((n_chains, R, C, S), generator=gen, device=dev)
        gumbel = u.clamp_(tiny, below_one).log_().neg_().log_().neg_()
        logits = gumbel.add_(ll).add_(theta.log().unsqueeze(2))
        draw = logits.argmax(dim=-1)                              # [ch, R, C]
        del u, gumbel, logits
        if it >= n_burn:
            theta_sum += theta
            # shared per-cell frequency: eps_sum[r, c, draw[x, r, c]] += 1
            eps_sum.scatter_add_(2, draw.permute(1, 2, 0), ones)
            k, rem = divmod(it - n_burn, thin)
            if rem == 0 and k < n_keep:
                traces[k] = theta
    theta_mean = (theta_sum / n_iter).mean(dim=0)                 # [R, S]
    eps_freq = eps_sum / (n_iter * n_chains)                      # [R, Cmax, S]
    return theta_mean, eps_freq, traces.transpose(0, 1)


def region_loglik(expr_cg: np.ndarray, regions: List[dict],
                  mu: np.ndarray, tau: np.ndarray, chunk: int = 16384,
                  device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-region, per-cell, per-state Gaussian log-likelihood summed over
    each region's genes, in the padded-group layout, on the device.

        ll[r, c, s] = -tau_s/2 (X2[c,r] - 2 mu_s X1[c,r] + n_r mu_s^2)
                      + n_r const_s

    with X1 = x @ RG^T and X2 = x^2 @ RG^T, two matmuls streamed over cell
    chunks.  Only the rows the block's regions read are uploaded (unless
    they cover most of the matrix or their copy would pass ~6 GB); each
    region's cell group is padded to the widest group.  A disk memmap's
    rows are read through its file (utils/memmap.py).

    Returns (ll [R, Cmax, S], cell_mask [R, Cmax]) as float32 tensors."""
    dev = resolve_device(device)
    R = len(regions)
    C, G = expr_cg.shape
    RG = np.zeros((R, G), np.float32)
    for ri, r in enumerate(regions):
        RG[ri, r["gene_idx"]] = 1.0
    n_genes_r = RG.sum(axis=1)                                     # [R]
    RGT = torch.from_numpy(np.ascontiguousarray(RG.T)).to(dev)     # [G, R]
    union = np.unique(np.concatenate([r["cell_idx"] for r in regions]))
    use_subset = (union.size <= int(0.6 * C)
                  and union.size * G * 4 < 6e9)
    if use_subset:
        pos = np.full(C, -1, np.int64)
        pos[union] = np.arange(union.size)
        x_src = gather_rows(expr_cg, union)
    else:
        pos = None
        x_src = expr_cg
    parts1, parts2 = [], []
    for b in range(0, x_src.shape[0], chunk):
        xc = torch.as_tensor(np.ascontiguousarray(read_rows(x_src, b, b + chunk)),
                             dtype=torch.float32).to(dev)
        parts1.append(xc @ RGT)
        parts2.append((xc * xc) @ RGT)
    X1 = torch.cat(parts1) if len(parts1) > 1 else parts1[0]        # [C', R]
    X2 = torch.cat(parts2) if len(parts2) > 1 else parts2[0]

    Cmax = max(r["cell_idx"].size for r in regions)
    pad_idx = np.zeros((R, Cmax), np.int64)
    cell_mask = np.zeros((R, Cmax), np.float32)
    for ri, r in enumerate(regions):
        nc = r["cell_idx"].size
        src_rows = pos[r["cell_idx"]] if use_subset else r["cell_idx"]
        pad_idx[ri, :nc] = src_rows
        cell_mask[ri, :nc] = 1.0
    rr = torch.arange(R, device=dev)[:, None]
    pj = torch.from_numpy(pad_idx).to(dev)
    X1p = X1[pj, rr]                                               # [R, Cmax]
    X2p = X2[pj, rr]
    muj = torch.as_tensor(np.asarray(mu), dtype=torch.float32).to(dev)
    tauj = torch.as_tensor(np.asarray(tau), dtype=torch.float32).to(dev)
    const = 0.5 * torch.log(tauj / (2.0 * np.pi))
    ng = torch.from_numpy(n_genes_r).to(dev)[:, None, None]
    ll = (-0.5 * tauj[None, None, :]
          * (X2p[..., None] - 2.0 * muj[None, None, :] * X1p[..., None]
             + ng * muj[None, None, :] ** 2)
          + ng * const[None, None, :])                             # [R, Cmax, S]
    mask = torch.from_numpy(cell_mask).to(dev)
    # padded slots must not influence the theta counts
    return ll * mask[..., None], mask


def _host(a) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_bayesian_mixture(
    obj: InferCNV,
    hmm_states: np.ndarray,
    hmm_type: str,
    hspike: Optional[InferCNV],
    report_by: str = "subcluster",
    seed: int = 12345,
    device: DeviceLike = None,
) -> Tuple[BayesResult, List[dict]]:
    """Compute posterior state probabilities for every non-neutral CNV region.

    Returns (BayesResult, region descriptors [{name, gene_idx, cell_idx, state}])."""
    dev = resolve_device(device)
    S = 6 if hmm_type == "i6" else 3
    neutral = hmm_mod.NEUTRAL_STATE_I6 if hmm_type == "i6" else hmm_mod.NEUTRAL_STATE_I3
    result = BayesResult()
    t0 = time.perf_counter()

    # (mu, tau) per state (reference MeanSD :148-198)
    if hmm_type == "i6":
        if hspike is None:
            raise ValueError("i6 Bayes filtering requires the hspike object")
        cnv_mean_sd = hmm_mod.get_spike_dists(hspike)
        mu = np.array([cnv_mean_sd[lvl][0] for lvl in hmm_mod.I6_LEVELS])
        sd = np.array([cnv_mean_sd[lvl][1] for lvl in hmm_mod.I6_LEVELS])
    else:
        params = hmm_mod.i3_hmm_params(
            obj.expr, list(obj.ref_groups.values()), list(obj.obs_groups.values()))
        mu, sd = params.means, params.sds
    tau = 1.0 / sd**2

    # region structures from the HMM state matrix (the reference reads the
    # step-17 report files; neutral regions are excluded there)
    group_regions = get_predicted_cnv_regions(obj, hmm_states, by=report_by)
    name_to_gene_idx = {n: i for i, n in enumerate(obj.gene_order.names)}
    regions: List[dict] = []
    name_to_cell_idx = {n: i for i, n in enumerate(obj.cell_names)}
    for gr in group_regions:
        cidx = np.array([name_to_cell_idx[c] for c in gr.cells], np.int64)
        for r in gr.regions:
            if r.state == neutral:
                continue
            gidx = np.array([name_to_gene_idx[g] for g in r.genes], np.int64)
            regions.append({
                "name": r.name, "gene_idx": gidx, "cell_idx": cidx,
                "state": r.state, "group": gr.group_name,
            })

    result.regions = regions
    if not regions:
        result.seconds["regions"] = time.perf_counter() - t0
        return result, regions
    R = len(regions)
    log_info(f"Bayesian mixture model over {R} CNV regions ({S} states)")

    n_chains = N_CHAINS_I6 if hmm_type == "i6" else N_CHAINS_I3

    # Region blocks: the sweep's [chains, R_blk, Cmax_blk, S] transients
    # stay under a fixed budget; regions sorted by group size, so each
    # block pads to its own widest group (the reference bounds this with
    # mclapply over regions, inferCNV_BayesNet.R:407-430)
    BUDGET = _GIBBS_TRANSIENT_BUDGET
    order = sorted(range(R), key=lambda ri: -regions[ri]["cell_idx"].size)
    blocks: List[List[int]] = []
    cur: List[int] = []
    cur_cmax = 0
    for ri in order:
        cmax = max(cur_cmax, regions[ri]["cell_idx"].size)
        if cur and n_chains * (len(cur) + 1) * cmax * S > BUDGET:
            blocks.append(cur)
            cur, cur_cmax = [ri], regions[ri]["cell_idx"].size
        else:
            cur.append(ri)
            cur_cmax = cmax
    if cur:
        blocks.append(cur)
    if len(blocks) > 1:
        log_info(f"-sampling in {len(blocks)} region blocks (memory budget)")

    # diagnostics traces: the full post-burn-in theta draws, thinned only
    # if the host trace tensor would pass ~256 MB; from the total region
    # count, so every block's traces share a time axis
    full_bytes = N_ITER * n_chains * R * S * 4
    thin = int(max(1, -(-full_bytes // (256 * 1024 * 1024))))
    if thin > 1:
        log_info(f"-theta diagnostics traces thinned 1-in-{thin} "
                 f"({R} regions; full traces would be {full_bytes/1e6:.0f} MB)")
    result.seconds["regions"] = time.perf_counter() - t0

    theta_mean = np.zeros((R, S), np.float64)
    cell_probs: List[Optional[np.ndarray]] = [None] * R
    trace_list: List[np.ndarray] = []
    for bi, blk in enumerate(blocks):
        blk_regions = [regions[ri] for ri in blk]
        t0 = time.perf_counter()
        ll, cell_mask = region_loglik(obj.expr, blk_regions, mu, tau, device=dev)
        _sync(dev)
        t1 = time.perf_counter()
        th, ef, tr = _gibbs_all_regions(
            block_generator(seed, bi, dev), ll, cell_mask,
            n_chains, N_BURN, N_ITER, thin=thin)
        th, ef, tr = _host(th), _host(ef), _host(tr)
        result.seconds["loglik"] += t1 - t0
        result.seconds["sampler"] += time.perf_counter() - t1
        result.sweeps += N_BURN + N_ITER
        for j, ri in enumerate(blk):
            theta_mean[ri] = th[j]
            cell_probs[ri] = ef[j, : regions[ri]["cell_idx"].size, :].T
        trace_list.append(tr)
    # traces back in original region order: [chains, T, R, S]
    flat = np.concatenate(trace_list, axis=2)
    inv = np.empty(R, np.int64)
    inv[[ri for blk in blocks for ri in blk]] = np.arange(R)
    result.theta_traces = flat[:, :, inv, :]

    result.cnv_region_names = [r["name"] for r in regions]
    result.cnv_state_probabilities = theta_mean.T                  # [S, R]
    result.cell_probabilities = cell_probs

    # convergence check on the theta chains (the reference computes Gelman
    # plots but never inspects them; here poor mixing is surfaced loudly)
    try:
        from infercnv_tpu_torch.viz.bayes_plots import gelman_rubin

        rhat = gelman_rubin(result.theta_traces)                   # [R, S]
        worst = float(np.nanmax(rhat))
        if worst > 1.1:
            bad = [result.cnv_region_names[i]
                   for i in np.nonzero(np.nanmax(rhat, axis=-1) > 1.1)[0][:5]]
            log_warn(f"Gibbs chains poorly mixed (max R-hat {worst:.3f} > 1.1) "
                     f"for region(s) {bad}; posterior filtering decisions for "
                     "these regions may be unstable")
    except Exception:  # diagnostics must never fail an analysis
        pass
    return result, regions


def remove_cells_filter(
    obj: InferCNV,
    hmm_states: np.ndarray,
    hmm_type: str,
    BayesMaxPNormal: float,
    hspike: Optional[InferCNV],
    report_by: str = "subcluster",
    seed: int = 12345,
    max_rounds: int = 5,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, BayesResult]:
    """Alternative postMcmcMethod='removeCells' (reference removeCells
    :650-685): per region, cells whose posterior P(eps = normal) exceeds the
    threshold get the region reset to neutral for those cells only; the
    sampler re-runs until no such cells remain."""
    neutral = hmm_mod.NEUTRAL_STATE_I6 if hmm_type == "i6" else hmm_mod.NEUTRAL_STATE_I3
    states = (hmm_states.materialize() if hasattr(hmm_states, "materialize")
              else np.array(hmm_states))
    result = BayesResult()
    for round_i in range(max_rounds):
        result, regions = run_bayesian_mixture(
            obj, states, hmm_type, hspike, report_by=report_by,
            seed=seed + round_i, device=device)
        if not regions:
            return states, result
        changed = 0
        for ri, r in enumerate(regions):
            cell_p = result.cell_probabilities[ri]  # [S, n_cells]
            bad = np.nonzero(cell_p[neutral - 1] > BayesMaxPNormal)[0]
            if bad.size:
                states[np.ix_(r["cell_idx"][bad], r["gene_idx"])] = neutral
                changed += bad.size
        log_info(f"removeCells round {round_i}: reset {changed} cell-regions")
        if changed == 0:
            break
    return states, result


def _write_probabilities(out_dir: str, names: List[str], probs: np.ndarray) -> None:
    """CNV_State_Probabilities.dat: region names, then one row a state."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "CNV_State_Probabilities.dat")
    with open(path, "w") as f:
        f.write("\t".join(names) + "\n")
        for s in range(probs.shape[0]):
            f.write(f"State:{s+1}\t" + "\t".join(f"{v:.6g}" for v in probs[s]) + "\n")
    log_info(f"-wrote {path}")


def bayesian_filter_states(
    obj: InferCNV,
    hmm_states: np.ndarray,
    hmm_type: str,
    BayesMaxPNormal: float,
    hspike: Optional[InferCNV],
    reassign: bool = True,
    out_dir: Optional[str] = None,
    report_by: str = "subcluster",
    seed: int = 12345,
    post_mcmc_method: str = "removeCNV",
    device: DeviceLike = None,
) -> Tuple[np.ndarray, BayesResult]:
    """removeCNV + reassignCNV (reference filterHighPNormals :1394-1440).

    Returns (filtered state matrix, BayesResult)."""
    neutral = hmm_mod.NEUTRAL_STATE_I6 if hmm_type == "i6" else hmm_mod.NEUTRAL_STATE_I3
    if post_mcmc_method == "removeCells":
        states, result = remove_cells_filter(
            obj, hmm_states, hmm_type, BayesMaxPNormal, hspike,
            report_by=report_by, seed=seed, device=device)
        # the reference runs reassignCNV after removeCells too
        # (inferCNV_BayesNet.R:1416-1421)
        if reassign and result.regions:
            probs = result.cnv_state_probabilities
            for ri, r in enumerate(result.regions):
                best = int(np.argmax(probs[:, ri])) + 1
                if best != r["state"]:
                    result.reassigned.append((r["name"], r["state"], best))
                states[np.ix_(r["cell_idx"], r["gene_idx"])] = best
            if result.reassigned:
                log_info(f"Reassigned {len(result.reassigned)} CNV region(s) "
                         "to their argmax posterior state (post removeCells)")
        if out_dir is not None and result.cnv_state_probabilities is not None:
            _write_probabilities(out_dir, result.cnv_region_names,
                                 result.cnv_state_probabilities)
        return states, result
    result, regions = run_bayesian_mixture(
        obj, hmm_states, hmm_type, hspike, report_by=report_by, seed=seed,
        device=device)
    # region descriptors come from the factorized form when given; the
    # per-region rewrites below need the expanded matrix
    states = (hmm_states.materialize() if hasattr(hmm_states, "materialize")
              else np.array(hmm_states))
    if not regions:
        return states, result

    probs = result.cnv_state_probabilities  # [S, R]
    p_normal = probs[neutral - 1]
    keep: List[int] = []
    for ri, r in enumerate(regions):
        if p_normal[ri] > BayesMaxPNormal:
            states[np.ix_(r["cell_idx"], r["gene_idx"])] = neutral
            result.removed_regions.append(r["name"])
        else:
            keep.append(ri)
    log_info(f"Removed {len(result.removed_regions)} CNV region(s) with "
             f"P(normal) > {BayesMaxPNormal}")

    if reassign:
        for ri in keep:
            r = regions[ri]
            best = int(np.argmax(probs[:, ri])) + 1
            if best != r["state"]:
                result.reassigned.append((r["name"], r["state"], best))
            states[np.ix_(r["cell_idx"], r["gene_idx"])] = best
        if result.reassigned:
            log_info(f"Reassigned {len(result.reassigned)} CNV region(s) to "
                     "their argmax posterior state")

    if out_dir is not None:
        kept_probs = probs[:, keep] if keep else np.zeros((probs.shape[0], 0))
        _write_probabilities(out_dir, [regions[ri]["name"] for ri in keep],
                             kept_probs)
    return states, result


# ---------------------------------------------------------------------------
# API-parity aliases (reference exported names: inferCNVBayesNet
# R/inferCNV_BayesNet.R:1237, filterHighPNormals :1394)
# ---------------------------------------------------------------------------

def inferCNVBayesNet(infercnv_obj: InferCNV, HMM_states: np.ndarray,
                     HMM_type: str = "i6", report_by: str = "subcluster",
                     seed: int = 12345, device: DeviceLike = None):
    """Run the Bayesian mixture model; returns a BayesResult (the MCMC_inferCNV
    analogue) plus the modeled region descriptors."""
    return run_bayesian_mixture(infercnv_obj, HMM_states, HMM_type,
                                infercnv_obj.hspike, report_by=report_by,
                                seed=seed, device=device)


def filterHighPNormals(infercnv_obj: InferCNV, HMM_states: np.ndarray,
                       BayesMaxPNormal: float = 0.5, HMM_type: str = "i6",
                       reassignCNVs: bool = True,
                       postMcmcMethod: str = "removeCNV",
                       out_dir=None, report_by: str = "subcluster",
                       seed: int = 12345, device: DeviceLike = None):
    """Posterior filtering of HMM CNV calls; returns (states, BayesResult)."""
    return bayesian_filter_states(
        infercnv_obj, HMM_states, HMM_type, BayesMaxPNormal,
        infercnv_obj.hspike, reassign=reassignCNVs, out_dir=out_dir,
        report_by=report_by, seed=seed, post_mcmc_method=postMcmcMethod,
        device=device)
