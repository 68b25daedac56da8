"""Tumor subclustering driver for the hierarchical-clustering partitions.

Counterpart of infercnv_tpu/subcluster/partition.py: ``ward_linkage``,
``_cut_groups_ordered``, ``zscore_gene_filter``,
``_single_tumor_hclust_subclustering`` and ``define_tumor_subclusters`` for
the partition methods 'qnorm', 'pheight', 'qgamma' and 'none', with the
hspike mirror (lines 1-254, 364-536).  The gene filter and the tree cuts
are the reference's host numpy and scipy; the distances of a group of more
than 1,024 cells are a float32 product on ``device``
(subcluster/distance.py).  Not ported yet (ROADMAP A6): the 'leiden' and
'random_trees' partitions, the per-chromosome subclusters and
``split_references``; they raise NotImplementedError
(``_group_linkage_scalable``, the Leiden route's dendrogram, comes with
them).

reference: define_signif_tumor_subclusters
(R/inferCNV_tumor_subclusters.R:2-177) with the ward.D2 tree cut (:181-268).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import stats
from scipy.cluster import hierarchy

from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.device import DeviceLike
from infercnv_tpu_torch.subcluster.distance import condensed_dists
from infercnv_tpu_torch.utils.logging import log_info, log_warn

#: Above this many cells an hclust partition warns that it is O(n^2) in
#: time and memory (the condensed distances would be ~40 GB at 100k cells).
LINKAGE_MAX_CELLS = 8000

#: Cumulative per-phase wall seconds of the LAST define_tumor_subclusters
#: call; the pipeline copies them into step_timings as
#: `15_subclusters.<phase>` rows.
PHASE_TIMES: Dict[str, float] = {}

_NOT_PORTED = ("leiden", "random_trees")


def _phase(name: str, t0: float) -> None:
    PHASE_TIMES[name] = PHASE_TIMES.get(name, 0.0) + (time.perf_counter() - t0)


def ward_linkage(x_cg: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """hclust(dist(x), 'ward.D2') equivalent: scipy 'ward' on euclidean."""
    if x_cg.shape[0] < 2:
        raise ValueError("need >= 2 cells for linkage")
    return hierarchy.linkage(condensed_dists(x_cg, device), method="ward")


def _cut_groups_ordered(Z: np.ndarray, height: float) -> np.ndarray:
    return hierarchy.fcluster(Z, t=height, criterion="distance")


def zscore_gene_filter(obj: InferCNV, z_score_filter: float) -> np.ndarray:
    """Gene indices to KEEP after dropping genes with mean |z| >= threshold,
    z computed on the pooled reference matrix (reference :45-68)."""
    if z_score_filter <= 0 or not obj.has_reference_cells():
        return np.arange(obj.num_genes)
    ref = obj.expr[obj.all_ref_idx()]
    z = (ref - ref.mean()) / ref.std(ddof=1)
    outliers = np.abs(z).mean(axis=0) >= z_score_filter
    if outliers.any():
        log_info(f"z_score_filter: masking {int(outliers.sum())} genes for subclustering")
    return np.nonzero(~outliers)[0]


def _single_tumor_hclust_subclustering(
    group_name: str,
    group_idx: np.ndarray,
    expr_sub: np.ndarray,
    p_val: float,
    partition_method: str,
    device: DeviceLike = None,
) -> Tuple[Optional[np.ndarray], Dict[str, np.ndarray]]:
    """reference .single_tumor_subclustering (:181-268)."""
    n = group_idx.shape[0]
    if n <= 2:
        return None, {f"{group_name}_s1": group_idx}
    if n > LINKAGE_MAX_CELLS:
        log_warn(f"hclust partition ({partition_method}) on {n} cells is "
                 f"O(n^2) in time and memory; use partition_method='leiden' "
                 "at this scale")
    Z = ward_linkage(expr_sub, device)
    heights = Z[:, 2]
    if partition_method == "pheight":
        cut_height = p_val * heights.max()
    elif partition_method == "qnorm":
        cut_height = stats.norm.ppf(1 - p_val, loc=heights.mean(), scale=heights.std(ddof=1))
    elif partition_method == "qgamma":
        # fitdist(heights, 'gamma') MLE then qgamma(1 - p_val)
        a, loc, scale = stats.gamma.fit(heights, floc=0)
        cut_height = stats.gamma.ppf(1 - p_val, a, loc=loc, scale=scale)
    elif partition_method == "none":
        cut_height = np.inf
    elif partition_method == "shc":
        # accepted by the reference's match.arg but its implementation is
        # commented out (inferCNV_tumor_subclusters.R:225-227, 271-300)
        raise NotImplementedError(
            "partition_method='shc' is disabled in the reference (sigclust2 "
            "branch commented out); use qnorm/pheight/qgamma/leiden/random_trees"
        )
    else:
        raise ValueError(f"unrecognized partition_method {partition_method!r}")
    grps = _cut_groups_ordered(Z, cut_height) if np.isfinite(cut_height) else np.ones(n, int)
    subclusters: Dict[str, np.ndarray] = {}
    # reference orders subcluster contents by dendrogram leaf order (:247-260)
    leaf_order = hierarchy.leaves_list(Z)
    for g in np.unique(grps):
        members = leaf_order[grps[leaf_order] == g]
        subclusters[f"{group_name}_s{g}"] = group_idx[members]
    return Z, subclusters


def split_references(obj: InferCNV, num_groups: int = 2,
                     hclust_method: str = "complete") -> None:
    """Re-split the reference cells (reference split_references
    R/inferCNV_ops.R:1917-1947): not ported yet."""
    raise NotImplementedError(
        "split_references (num_ref_groups) is not ported yet (ROADMAP A6)")


def define_tumor_subclusters(
    obj: InferCNV,
    p_val: float = 0.1,
    cluster_by_groups: bool = True,
    partition_method: str = "qnorm",
    z_score_filter: float = 0.8,
    device: DeviceLike = None,
) -> None:
    """Populate obj.tumor_subclusters = {"hc": {group: linkage},
    "subclusters": {group: {subcluster_name: cell indices}}}.

    Mirrors define_signif_tumor_subclusters (:2-177) for the hclust
    partitions: observation groups (plus reference groups) are partitioned
    independently; the hspike child gets partition_method='none'
    (:155-160).  The tree is always Ward's (the reference's hclust_method
    does not reach these partitions)."""
    if partition_method in _NOT_PORTED:
        raise NotImplementedError(
            f"partition_method={partition_method!r} is not ported yet "
            "(ROADMAP A6)")
    log_info(f"define_tumor_subclusters(p_val={p_val}, method={partition_method})")
    PHASE_TIMES.clear()
    if cluster_by_groups:
        tumor_groups: Dict[str, np.ndarray] = {**{k: np.asarray(v) for k, v in obj.obs_groups.items()},
                                               **{k: np.asarray(v) for k, v in obj.ref_groups.items()}}
    else:
        tumor_groups = {"all_observations": obj.all_obs_idx(),
                        **{k: np.asarray(v) for k, v in obj.ref_groups.items()}}

    t0 = time.perf_counter()
    keep_genes = zscore_gene_filter(obj, z_score_filter)
    _phase("z_filter", t0)
    t0 = time.perf_counter()
    if obj.expr.size > 2_000_000_000:
        # never materialize the full gene-filtered copy; each group slices
        # its own rows instead
        expr = None
    else:
        expr = obj.expr[:, keep_genes]
    _phase("gene_filter", t0)

    res: Dict[str, dict] = {"hc": {}, "subclusters": {}}
    for group, idx in tumor_groups.items():
        log_info(f"define_tumor_subclusters(), tumor: {group}")
        t0 = time.perf_counter()
        sub_expr = (obj.expr[np.ix_(idx, keep_genes)] if expr is None
                    else expr[idx])
        _phase("slice", t0)
        Z, subclusters = _single_tumor_hclust_subclustering(
            group, idx, sub_expr, p_val, partition_method, device)
        res["hc"][group] = Z
        res["subclusters"][group] = subclusters
    obj.tumor_subclusters = res

    if PHASE_TIMES:
        log_info("-subcluster phases: " + " ".join(
            f"{k}={v:.1f}s" for k, v in sorted(PHASE_TIMES.items(),
                                               key=lambda kv: -kv[1])))
    if obj.hspike is not None:
        log_info("-mirroring subclusters for hspike (partition_method='none')")
        phases = dict(PHASE_TIMES)  # the recursive call clears the registry
        define_tumor_subclusters(obj.hspike, cluster_by_groups=True,
                                 partition_method="none", z_score_filter=0.0,
                                 device=device)
        PHASE_TIMES.clear()
        PHASE_TIMES.update(phases)
