"""Non-DE gene masking (experimental pipeline step 21).

Counterpart of infercnv_tpu/ops/de_mask.py (lines 1-166), host numpy and
scipy copied from there: the BH adjustment, the Wilcoxon and Welch t tests
vectorised across the gene axis, and the masking policy.  The permutation
test's label permutations come from a CPU ``torch.Generator`` seeded with
``seed`` (the reference draws them with ``jax.random``, which torch cannot
repeat), and its mean differences are computed with torch on ``device``.

reference: R/inferCNV_mask_non_DE.R: per (tumor subcluster x normal group)
pair, a per-gene two-sample test (wilcoxon / t / permutation) with BH
adjustment; genes not DE (per the require_DE_all_normals policy) are masked
to the matrix mean (.mask_DE_genes :77-134, get_DE_genes_basic :158-259).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from scipy import stats as sstats

from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.utils.logging import log_info


def bh_adjust(pvals: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg adjustment (R p.adjust method='BH')."""
    p = np.asarray(pvals, np.float64)
    n = p.size
    order = np.argsort(p)[::-1]  # descending
    ranked = p[order] * n / np.arange(n, 0, -1)
    adj = np.minimum.accumulate(ranked)
    out = np.empty_like(p)
    out[order] = np.minimum(adj, 1.0)
    return out


def _wilcoxon_pvals(x1: np.ndarray, x2: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized two-sided Mann-Whitney with normal approximation.
    x1: [n1, G], x2: [n2, G].  The reference jitters values to break ties
    (inferCNV_mask_non_DE.R:197-203), so we use the no-ties formula after
    adding the same style of noise."""
    rng = np.random.default_rng(seed)
    x1 = x1 + rng.normal(0.0001, 0.0001, x1.shape)
    x2 = x2 + rng.normal(0.0001, 0.0001, x2.shape)
    n1, G = x1.shape
    n2 = x2.shape[0]
    allv = np.concatenate([x1, x2], axis=0)
    ranks = np.argsort(np.argsort(allv, axis=0), axis=0) + 1.0
    r1 = ranks[:n1].sum(axis=0)
    u1 = r1 - n1 * (n1 + 1) / 2.0
    mu = n1 * n2 / 2.0
    sigma = np.sqrt(n1 * n2 * (n1 + n2 + 1) / 12.0)
    z = (np.abs(u1 - mu) - 0.5) / sigma  # continuity correction
    return 2.0 * sstats.norm.sf(z)


def _t_pvals(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Vectorized Welch t-test (R t.test default)."""
    m1, m2 = x1.mean(0), x2.mean(0)
    v1, v2 = x1.var(0, ddof=1), x2.var(0, ddof=1)
    n1, n2 = x1.shape[0], x2.shape[0]
    se2 = v1 / n1 + v2 / n2
    t = (m1 - m2) / np.sqrt(np.maximum(se2, 1e-300))
    df = se2**2 / np.maximum(
        (v1 / n1) ** 2 / (n1 - 1) + (v2 / n2) ** 2 / (n2 - 1), 1e-300)
    return 2.0 * sstats.t.sf(np.abs(t), df)


def perm_permutations(n: int, n_perm: int, seed: int = 0) -> torch.Tensor:
    """[n_perm, n] int64 permutations of the n pooled cells, on the CPU."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    return torch.stack([torch.randperm(n, generator=gen) for _ in range(n_perm)])


def _perm_pvals(x1: np.ndarray, x2: np.ndarray, n_perm: int = 999, seed: int = 0,
                device: DeviceLike = None) -> np.ndarray:
    """Vectorized permutation one-way test (coin::oneway_test analogue):
    p = (1 + #{permutations with |mean diff| >= observed}) / (n_perm + 1).
    Each block of permutations is one product of its [block, n] 0/1
    first-group indicator with the pooled [n, G] values (float64)."""
    dev = resolve_device(device)
    n1 = x1.shape[0]
    allv = torch.as_tensor(np.concatenate([x1, x2], axis=0).astype(np.float64)).to(dev)
    n = allv.shape[0]
    total = allv.sum(dim=0)

    def absdiff(w):
        s1 = w @ allv
        return torch.abs(s1 / n1 - (total - s1) / (n - n1))

    w0 = torch.zeros((1, n), dtype=torch.float64, device=dev)
    w0[0, :n1] = 1.0
    obs = absdiff(w0)[0]
    perms = perm_permutations(n, n_perm, seed)
    count = torch.zeros(allv.shape[1], dtype=torch.int64, device=dev)
    for b in range(0, n_perm, 128):
        pb = perms[b:b + 128]
        w = torch.zeros((pb.shape[0], n), dtype=torch.float64)
        w.scatter_(1, pb[:, :n1], 1.0)
        count += (absdiff(w.to(dev)) >= obs[None, :]).sum(dim=0)
    return (count.cpu().numpy() + 1.0) / (n_perm + 1.0)


def get_DE_genes_basic(obj: InferCNV, p_val_thresh: float = 0.05,
                       test_use: str = "wilcoxon",
                       device: DeviceLike = None) -> List[dict]:
    """reference get_DE_genes_basic (:158-259): per tumor subcluster x
    normal group, BH-adjusted p-values and the DE gene set."""
    results: List[dict] = []
    gene_names = np.array(obj.gene_order.names)
    for tumor_type, group_idx in obj.obs_groups.items():
        if obj.tumor_subclusters and tumor_type in obj.tumor_subclusters["subclusters"]:
            sub_lists = obj.tumor_subclusters["subclusters"][tumor_type]
        else:
            sub_lists = {tumor_type: np.asarray(group_idx)}
        for sub_name, tumor_idx in sub_lists.items():
            tumor_idx = np.asarray(tumor_idx)
            for normal_type, normal_idx in obj.ref_groups.items():
                log_info(f"Finding DE genes between {sub_name} and {normal_type}")
                x1 = obj.expr[np.asarray(normal_idx)]
                x2 = obj.expr[tumor_idx]
                if test_use == "wilcoxon":
                    pvals = _wilcoxon_pvals(x1, x2)
                elif test_use == "t":
                    pvals = _t_pvals(x1, x2)
                elif test_use == "perm":
                    pvals = _perm_pvals(x1, x2, device=device)
                else:
                    raise ValueError(f"unknown test.use {test_use!r}")
                pvals = bh_adjust(np.nan_to_num(pvals, nan=1.0))
                de = gene_names[pvals < p_val_thresh]
                log_info(f"Found {de.size} genes / {pvals.size} total as DE")
                results.append({
                    "tumor_indices": tumor_idx,
                    "normal": normal_type,
                    "pvals": pvals,
                    "de_genes": set(de.tolist()),
                })
    return results


def mask_non_DE_genes_basic(obj: InferCNV, p_val_thresh: float = 0.05,
                            test_use: str = "wilcoxon",
                            center_val: Optional[float] = None,
                            require_DE_all_normals: str = "any",
                            min_cluster_size_mask: int = 5,
                            device: DeviceLike = None) -> None:
    """reference mask_non_DE_genes_basic (:28-52) + .mask_DE_genes (:77-134)."""
    if center_val is None:
        center_val = float(obj.expr.mean())
    all_results = get_DE_genes_basic(obj, p_val_thresh, test_use, device)

    num_normals = len(obj.ref_groups)
    gene_names = np.array(obj.gene_order.names)
    # per-CLUSTER gene counts: every cell in a tumor cluster shares the
    # same DE profile, so a [n_clusters, G] count table replaces the old
    # dense [C, G] int32 matrix (+ a second full np.where copy) — ~8 GB of
    # avoided writes at 100k cells
    cluster_counts: dict = {}
    for res in all_results:
        idx = res["tumor_indices"]
        if idx.size < min_cluster_size_mask:
            continue
        key = idx.tobytes()
        if key not in cluster_counts:
            cluster_counts[key] = (idx, np.zeros(gene_names.size, np.int32))
        cluster_counts[key][1][np.isin(gene_names, list(res["de_genes"]))] += 1

    if require_DE_all_normals not in ("all", "most", "any"):
        raise ValueError(
            f"unrecognized require_DE_all_normals {require_DE_all_normals!r}")
    expr = obj.expr.copy()  # rebind-only discipline: never mutate shared
    for idx, counts in cluster_counts.values():
        if require_DE_all_normals == "all":
            gcols = counts != num_normals
        elif require_DE_all_normals == "most":
            gcols = counts < num_normals / 2.0
        else:  # "any"
            gcols = counts == 0
        if gcols.any():
            expr[np.ix_(idx, np.nonzero(gcols)[0])] = np.float32(center_val)
    obj.expr = expr
