"""Tumor subclustering (step 15).

Counterpart of infercnv_tpu/subcluster/partition.py (lines 1-536): the
Leiden partition on a kNN/SNN graph of the PCA embedding or of the rows
themselves ('leiden', the default), the Ward tree cuts ('qnorm', 'pheight',
'qgamma', 'none'), the recursive permutation test ('random_trees'), the
per-chromosome subclusters, ``split_references``, and the hspike mirror.
The gene filter, the tree cuts and linkages, random_trees and the graph
construction are the reference's host numpy and scipy, copied; the
embedding (subcluster/pca.py), the exact kNN and the distances of a group
of more than 1,024 cells (subcluster/distance.py) and the subcluster mean
profiles of a large group run on ``device``; the Leiden itself is the
reference's C++ (infercnv_tpu_torch/native).

Given the engine's residual as device chunks (``device_chunks``), the
Leiden route takes the gene filter and each group's rows on the device
from them, so the residual is not uploaded again.

reference: define_signif_tumor_subclusters
(R/inferCNV_tumor_subclusters.R:2-177) with partition methods:
  * 'leiden' (default): kNN/SNN graph + Leiden (:569-643, :699-741)
  * 'qnorm' | 'pheight' | 'qgamma' | 'none': ward.D2 tree cut (:181-268)
  * 'random_trees': recursive permutation test
    (inferCNV_tumor_subclusters.random_smoothed_trees.R:3-60, :403-531)
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy import stats
from scipy.cluster import hierarchy

from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.subcluster.distance import condensed_dists, knn_indices
from infercnv_tpu_torch.subcluster.leiden import (
    auto_resolution,
    knn_graph,
    leiden,
    snn_graph,
)
from infercnv_tpu_torch.subcluster.pca import pca_embed
from infercnv_tpu_torch.utils.logging import log_info, log_warn
from infercnv_tpu_torch.utils.memmap import gather_rows
from infercnv_tpu_torch.utils.profiling import memory_gb, memory_text

#: Above this many cells a group's stored dendrogram is built on subcluster
#: mean profiles instead of per-cell distances (the condensed distances
#: would be ~40 GB at 100k cells; the per-cell tree only orders plots), and
#: an hclust partition warns that it is O(n^2) in time and memory.
LINKAGE_MAX_CELLS = 8000

#: Cumulative per-phase wall seconds of the LAST define_tumor_subclusters
#: call (z_filter / gene_filter / slice / pca / knn / snn / leiden /
#: linkage); the pipeline copies them into step_timings as
#: `15_subclusters.<phase>` rows.
PHASE_TIMES: Dict[str, float] = {}
#: The largest resident set (VmRSS, GB) at the end of each phase of that
#: call, beside PHASE_TIMES (`15_subclusters.<phase>` rows' rss_gb).
PHASE_RSS_GB: Dict[str, float] = {}

#: Above this many residual elements, the host route slices each group's
#: rows from obj.expr (possibly a disk memmap) as it partitions it, instead
#: of first copying the whole gene-filtered matrix (reference
#: infercnv_tpu/subcluster/partition.py:440, the literal 2_000_000_000).
LAZY_SLICE_ELEMENTS = 2_000_000_000

#: The lazy slice gathers a group's rows this many at a time, reading a disk
#: memmap's rows through its file (utils/memmap.gather_rows), so a group's
#: slice holds its copy and none of the mapping's pages.
LAZY_SLICE_BLOCK_ROWS = 16384

#: Where the LAST define_tumor_subclusters call took its groups' rows:
#: "device_chunks" (the engine's residual kept on the device) or "host"
#: (obj.expr).
ROWS_FROM = "host"


def _phase(name: str, t0: float, sync=None) -> None:
    """Accumulate a phase timing; a CUDA result is waited for first, so a
    phase's work on the card is not counted in the next phase."""
    if torch.is_tensor(sync) and sync.device.type == "cuda":
        torch.cuda.synchronize(sync.device)
    PHASE_TIMES[name] = PHASE_TIMES.get(name, 0.0) + (time.perf_counter() - t0)
    PHASE_RSS_GB[name] = max(PHASE_RSS_GB.get(name, 0.0), memory_gb().get("rss_gb", 0.0))


def ward_linkage(x_cg: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """hclust(dist(x), 'ward.D2') equivalent: scipy 'ward' on euclidean."""
    if x_cg.shape[0] < 2:
        raise ValueError("need >= 2 cells for linkage")
    return hierarchy.linkage(condensed_dists(x_cg, device), method="ward")


def _group_linkage_scalable(expr_sub: np.ndarray,
                            subclusters: Dict[str, np.ndarray],
                            group_idx: np.ndarray,
                            device: DeviceLike = None) -> Optional[np.ndarray]:
    """Per-cell Ward tree for small groups; Ward tree over subcluster mean
    profiles above LINKAGE_MAX_CELLS (plot ordering only needs the
    between-subcluster structure)."""
    n = expr_sub.shape[0]
    if n <= LINKAGE_MAX_CELLS:
        return ward_linkage(expr_sub, device) if n >= 2 else None
    pos = {int(c): i for i, c in enumerate(group_idx)}
    profiles = np.stack([
        expr_sub[[pos[int(c)] for c in sidx]].mean(axis=0)
        for sidx in subclusters.values()
    ])
    if profiles.shape[0] < 2:
        return None
    log_info(f"-group of {n} cells > {LINKAGE_MAX_CELLS}: storing dendrogram "
             f"over {profiles.shape[0]} subcluster mean profiles")
    return ward_linkage(profiles, device)


def _cut_groups_ordered(Z: np.ndarray, height: float) -> np.ndarray:
    return hierarchy.fcluster(Z, t=height, criterion="distance")


def zscore_gene_filter(obj: InferCNV, z_score_filter: float) -> np.ndarray:
    """Gene indices to KEEP after dropping genes with mean |z| >= threshold,
    z computed on the pooled reference matrix (reference :45-68)."""
    if z_score_filter <= 0 or not obj.has_reference_cells():
        return np.arange(obj.num_genes)
    # the reference's (ref - mean) / sd and |z|, the same operations done in
    # place on the gathered copy: std's own [n_ref, G] temporary is the only
    # one beside it (the reference's expression makes three)
    ref = gather_rows(obj.expr, obj.all_ref_idx())
    if not np.issubdtype(ref.dtype, np.floating):
        ref = ref.astype(np.float64)   # as ref - mean would promote it
    mean, sd = ref.mean(), ref.std(ddof=1)
    np.subtract(ref, mean, out=ref)
    np.divide(ref, sd, out=ref)
    outliers = np.abs(ref, out=ref).mean(axis=0) >= z_score_filter
    if outliers.any():
        log_info(f"z_score_filter: masking {int(outliers.sum())} genes for subclustering")
    return np.nonzero(~outliers)[0]


def _leiden_partition(
    expr_sub,
    k_nn: int,
    resolution,
    method: str,
    objective: str,
    seed: int,
    upload_dtype=None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Partition one cell group ([n, G] host rows or a tensor).
    method: 'PCA' | 'simple'."""
    n = expr_sub.shape[0]
    res = auto_resolution(n) if resolution == "auto" else float(resolution)
    if method == "PCA":
        t0 = time.perf_counter()
        emb = pca_embed(expr_sub, n_components=10, upload_dtype=upload_dtype,
                        device=device)
        _phase("pca", t0, sync=emb)
        t0 = time.perf_counter()
        nn = knn_indices(emb, min(k_nn, n)).cpu().numpy()
        _phase("knn", t0)
        t0 = time.perf_counter()
        A = snn_graph(nn, n)
        if A.nnz == 0:
            A = knn_graph(nn, n, mode="undirected")
        _phase("snn", t0)
    else:
        t0 = time.perf_counter()
        nn = knn_indices(expr_sub, min(k_nn, n), device=device).cpu().numpy()
        _phase("knn", t0)
        t0 = time.perf_counter()
        A = knn_graph(nn, n, mode="undirected")
        _phase("snn", t0)
    t0 = time.perf_counter()
    part = leiden(A, res, objective=objective, seed=seed)
    _phase("leiden", t0)
    return part


def _device_mean_profiles(device_rows: torch.Tensor,
                          subclusters: Dict[str, np.ndarray],
                          group_idx: np.ndarray) -> np.ndarray:
    """Per-subcluster mean rows computed on the device from the group's
    device rows: one skinny [K, n] x [n, G] product and a [K, G] copy back."""
    pos = {int(c): i for i, c in enumerate(group_idx)}
    K = len(subclusters)
    onehot = np.zeros((K, device_rows.shape[0]), np.float32)
    for k, sidx in enumerate(subclusters.values()):
        onehot[k, [pos[int(c)] for c in sidx]] = 1.0 / len(sidx)
    w = torch.from_numpy(onehot).to(device_rows.device)
    return (w @ device_rows.to(torch.float32)).cpu().numpy()


def _single_tumor_leiden_subclustering(
    group_name: str,
    group_idx: np.ndarray,
    expr_sub: Optional[np.ndarray],
    k_nn: int,
    resolution,
    method: str,
    objective: str,
    seed: int,
    device_rows=None,
    upload_dtype=None,
    device: DeviceLike = None,
) -> Tuple[Optional[np.ndarray], Dict[str, np.ndarray]]:
    """reference .single_tumor_leiden_subclustering (:569-643).
    Returns (linkage or None, {subclusters_name: cell indices}).

    device_rows: optional [n, G_kept] tensor of the group's rows on the
    device; the Leiden route (PCA/kNN) then runs from it, and expr_sub (host
    rows) is needed only for a group small enough for a per-cell dendrogram
    (<= LINKAGE_MAX_CELLS)."""
    n = group_idx.shape[0]
    subclusters: Dict[str, np.ndarray] = {}
    if n < 3:
        log_info(f"Too few cells in group {group_name} for any (sub)clustering. Keeping as is.")
        return None, {f"{group_name}_s1": group_idx}
    if k_nn >= n:
        log_info(f"Less cells in group {group_name} than k_nn setting. Keeping as a single subcluster.")
        # expr_sub is None on the device route above LINKAGE_MAX_CELLS:
        # the single subcluster stands, only the per-cell dendrogram goes
        return (ward_linkage(expr_sub, device) if expr_sub is not None else None), \
            {group_name: group_idx}
    part = _leiden_partition(
        device_rows if device_rows is not None else expr_sub,
        k_nn, resolution, method, objective, seed,
        upload_dtype=upload_dtype, device=device)
    # name clusters 1..K largest-first (reference iterates sort(table) desc)
    labels, counts = np.unique(part, return_counts=True)
    order = labels[np.argsort(-counts, kind="stable")]
    for lab in order:
        subclusters[f"{group_name}_s{lab + 1}"] = group_idx[part == lab]
    t0 = time.perf_counter()
    if expr_sub is not None:
        Z = _group_linkage_scalable(expr_sub, subclusters, group_idx, device)
    else:
        profiles = _device_mean_profiles(device_rows, subclusters, group_idx)
        log_info(f"-group of {n} cells: dendrogram over "
                 f"{profiles.shape[0]} device-computed subcluster profiles")
        Z = ward_linkage(profiles, device) if profiles.shape[0] >= 2 else None
    _phase("linkage", t0)
    return Z, subclusters


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


def runmean_median_center(expr_cg: np.ndarray, k: int) -> np.ndarray:
    """caTools::runmean(k, endrule='mean') along the gene axis of each cell,
    then per-cell median centering: the pre-smoothing the reference applies
    before every tree build in random_trees
    (…random_smoothed_trees.R:71-73, :221-223).  The reference smooths over
    the whole gene axis here, ignoring chromosome boundaries."""
    x = np.asarray(expr_cg, np.float64)
    n, G = x.shape
    if G == 0 or k <= 1:
        sm = x.copy()
    else:
        h = (k - 1) // 2
        cs = np.concatenate([np.zeros((n, 1)), np.cumsum(x, axis=1)], axis=1)
        pos = np.arange(G)
        lo = np.maximum(pos - h, 0)
        hi = np.minimum(pos + h, G - 1)
        sm = (cs[:, hi + 1] - cs[:, lo]) / (hi - lo + 1)
    return sm - np.median(sm, axis=1, keepdims=True)


def _parameterize_random_cluster_heights_smoothed(
        expr_sub: np.ndarray, window_size: int, rng: np.random.Generator,
        n_iters: int = 100, device: DeviceLike = None):
    """reference .parameterize_random_cluster_heights_smoothed_trees
    (…random_smoothed_trees.R:217-290): the observed tree is built on the
    runmean-smoothed, median-centered matrix; each of the 100 null
    iterations permutes every gene column of the raw matrix across cells,
    re-smooths, re-centers, and records the max merge height;
    p = P(max_rand > max_obs)."""
    sm = runmean_median_center(expr_sub, window_size)
    Z = ward_linkage(sm, device)
    max_h = Z[:, 2].max()
    n, G = expr_sub.shape
    max_rand = np.empty(n_iters)
    for i in range(n_iters):
        # independent permutation of each gene column across cells
        perm_idx = np.argsort(rng.random((n, G)), axis=0)
        perm = np.take_along_axis(expr_sub, perm_idx, axis=0)
        Zr = ward_linkage(runmean_median_center(perm, window_size), device)
        max_rand[i] = Zr[:, 2].max()
    pval = float((max_rand > max_h).mean())  # 1 - ecdf(max_h)
    return Z, max_h, max_rand, pval


def _random_trees_recurse(
    group_idx: np.ndarray,
    expr_sub: np.ndarray,
    p_val: float,
    rng: np.random.Generator,
    window_size: int = 101,
    min_cluster_size_recurse: int = 10,
    max_recursion_depth: int = 3,
    depth: int = 1,
    device: DeviceLike = None,
) -> list:
    """Recursive permutation-test partitioning (reference
    .single_tumor_subclustering_recursive_random_smoothed_trees
    …random_smoothed_trees.R:130-211): recursion depth capped at 3, cut at
    the midpoint of the two largest merge heights, recurse only into
    subclusters of >= min_cluster_size_recurse (10) cells, and keep the
    parent when every subcluster is below that size.
    Returns list of index arrays (leaves of the recursion)."""
    n = group_idx.shape[0]
    if depth > max_recursion_depth or n <= 2:
        return [group_idx]
    Z, max_h, max_rand, pval = _parameterize_random_cluster_heights_smoothed(
        expr_sub, window_size, rng, device=device)
    if max_h <= 0 or pval > p_val:
        return [group_idx]
    h = np.sort(Z[:, 2])
    cut_height = (h[-1] + h[-2]) / 2.0 if h.size >= 2 else h[-1] / 2
    grps = _cut_groups_ordered(Z, cut_height)
    uniq = np.unique(grps)
    if all((grps == g).sum() < min_cluster_size_recurse for g in uniq):
        return [group_idx]
    out = []
    for g in uniq:
        sel = grps == g
        sub_idx = group_idx[sel]
        if sel.sum() >= min_cluster_size_recurse:
            out.extend(_random_trees_recurse(
                sub_idx, expr_sub[sel], p_val, rng, window_size,
                min_cluster_size_recurse, max_recursion_depth, depth + 1,
                device=device))
        else:
            out.append(sub_idx)
    return out


def split_references(obj: InferCNV, num_groups: int = 2,
                     hclust_method: str = "complete",
                     device: DeviceLike = None) -> None:
    """Re-split the pooled reference cells into `num_groups` by hierarchical
    clustering (reference split_references R/inferCNV_ops.R:1917-1947;
    'complete' linkage on euclidean distances, cutree k)."""
    ref_idx = obj.all_ref_idx()
    if ref_idx.size == 0:
        raise ValueError("no reference cells defined; cannot split into groups")
    d = condensed_dists(obj.expr[ref_idx], device)
    method = {"ward.D2": "ward", "complete": "complete", "average": "average",
              "single": "single"}.get(hclust_method, hclust_method)
    Z = hierarchy.linkage(d, method=method)
    grps = hierarchy.fcluster(Z, t=num_groups, criterion="maxclust")
    new_groups: Dict[str, np.ndarray] = {}
    counter = 0
    for g in np.unique(grps):
        counter += 1
        new_groups[f"refgrp-{counter}"] = ref_idx[grps == g]
    obj.ref_groups = new_groups


def define_tumor_subclusters(
    obj: InferCNV,
    p_val: float = 0.1,
    k_nn: int = 20,
    leiden_method: str = "PCA",
    leiden_function: str = "CPM",
    leiden_resolution="auto",
    leiden_method_per_chr: str = "simple",
    leiden_function_per_chr: str = "modularity",
    leiden_resolution_per_chr: float = 1.0,
    hclust_method: str = "ward.D2",
    cluster_by_groups: bool = True,
    partition_method: str = "leiden",
    per_chr_hmm_subclusters: bool = False,
    per_chr_hmm_subclusters_references: bool = False,
    z_score_filter: float = 0.8,
    seed: int = 12345,
    random_trees_window_size: int = 101,
    device_chunks=None,
    pca_upload_dtype=None,
    device: DeviceLike = None,
) -> Optional[Dict[str, Dict[str, np.ndarray]]]:
    """Populate obj.tumor_subclusters = {"hc": {group: linkage},
    "subclusters": {group: {subcluster_name: cell indices}}}; returns
    subclusters_per_chr or None.

    Mirrors define_signif_tumor_subclusters (:2-177): observation groups
    (plus reference groups) are partitioned independently; the hspike child
    gets partition_method='none' (:155-160).  The device work runs on
    `device` (CUDA unless the caller passes "cpu").

    device_chunks: optional [(start, n, tensor [>= n, G])], the engine's
    residual on the device.  The Leiden route then takes the gene filter
    and each group's rows on the device and feeds PCA/kNN from them, so
    nothing is uploaded again; the partitions are those of the host route
    (the same float32 values enter the same computation)."""
    global ROWS_FROM
    log_info(f"define_tumor_subclusters(p_val={p_val}, method={partition_method})")
    dev = resolve_device(device)
    PHASE_TIMES.clear()
    PHASE_RSS_GB.clear()
    lazy_slice = False
    if cluster_by_groups:
        tumor_groups: Dict[str, np.ndarray] = {**{k: np.asarray(v) for k, v in obj.obs_groups.items()},
                                               **{k: np.asarray(v) for k, v in obj.ref_groups.items()}}
    else:
        tumor_groups = {"all_observations": obj.all_obs_idx(),
                        **{k: np.asarray(v) for k, v in obj.ref_groups.items()}}

    dexpr = None
    if partition_method == "random_trees":
        # the reference subtracts the reference profile (count-space means,
        # inv_log=TRUE) on a copy before testing clusters
        # (…random_smoothed_trees.R:13) and applies no z-score gene filter
        from infercnv_tpu_torch.ops import transforms as T

        if obj.has_reference_cells():
            rgroups = [np.asarray(v) for v in obj.ref_groups.values()]
        else:
            rgroups = [obj.all_obs_idx()]
        x = T._f32(obj.expr, dev)
        means = T.ref_group_gene_means(x, T.group_onehot(rgroups, obj.num_cells),
                                       inv_log=True)
        expr = T.subtract_ref_expr(x, means, use_bounds=True).cpu().numpy()
        del x
        keep_genes = np.arange(obj.num_genes)
    else:
        t0 = time.perf_counter()
        keep_genes = zscore_gene_filter(obj, z_score_filter)
        _phase("z_filter", t0)
        expr = None
        use_device = (device_chunks is not None and partition_method == "leiden"
                      and not per_chr_hmm_subclusters)
        t0 = time.perf_counter()
        if use_device:
            kg = torch.as_tensor(keep_genes, device=device_chunks[0][2].device)
            dexpr = torch.cat([r[:nb].index_select(1, kg)
                               for (_b, nb, r) in device_chunks])
            _phase("gene_filter", t0, sync=dexpr)
        elif obj.expr.size > LAZY_SLICE_ELEMENTS:
            # never materialize the full gene-filtered copy (34 GB at
            # 1M x 8.5k); each group slices its own rows from the residual
            lazy_slice = True
            log_info(f"-lazy per-group slicing of the {obj.expr.size:,}-element "
                     f"residual (no full gene-filtered copy; {memory_text()})")
            _phase("gene_filter", t0)
        else:
            expr = obj.expr[:, keep_genes]
            _phase("gene_filter", t0)

    rows_from = "device_chunks" if dexpr is not None else "host"
    res: Dict[str, dict] = {"hc": {}, "subclusters": {}}
    rng = np.random.default_rng(seed)
    for gi, (group, idx) in enumerate(tumor_groups.items()):
        log_info(f"define_tumor_subclusters(), tumor: {group}")
        t0 = time.perf_counter()
        if dexpr is not None:
            # device route: host rows only for groups small enough to get
            # a per-cell dendrogram
            device_rows = dexpr.index_select(
                0, torch.as_tensor(idx, dtype=torch.int64, device=dexpr.device))
            sub_expr = (obj.expr[idx][:, keep_genes]
                        if idx.size <= LINKAGE_MAX_CELLS else None)
            _phase("slice", t0, sync=device_rows)
        elif lazy_slice:
            # one [n_group, G_kept] copy (np.ix_; chained fancy indexing
            # would first copy the full gene-width rows), in row blocks
            device_rows = None
            sub_expr = gather_rows(obj.expr, idx, keep_genes, LAZY_SLICE_BLOCK_ROWS)
            _phase("slice", t0)
            log_info(f"-group {group}: {idx.size} rows sliced ({memory_text()})")
        else:
            device_rows = None
            sub_expr = expr[idx]
            _phase("slice", t0)
        if partition_method == "leiden":
            Z, subclusters = _single_tumor_leiden_subclustering(
                group, idx, sub_expr, k_nn, leiden_resolution, leiden_method,
                leiden_function, seed + gi, device_rows=device_rows,
                upload_dtype=pca_upload_dtype, device=dev,
            )
        elif partition_method == "random_trees":
            parts = _random_trees_recurse(idx, sub_expr, p_val, rng,
                                          window_size=random_trees_window_size,
                                          device=dev)
            subclusters = {f"{group}_s{i+1}": p for i, p in enumerate(parts)}
            # the stored dendrogram is built on the smoothed, centered matrix
            # (…random_smoothed_trees.R:71-77)
            Z = (ward_linkage(runmean_median_center(sub_expr, random_trees_window_size), dev)
                 if idx.shape[0] > 2 else None)
        else:
            Z, subclusters = _single_tumor_hclust_subclustering(
                group, idx, sub_expr, p_val, partition_method, dev,
            )
        del device_rows, sub_expr   # not beside the next group's slice
        if lazy_slice:
            log_info(f"-group {group}: partitioned ({memory_text()})")
        res["hc"][group] = Z
        res["subclusters"][group] = subclusters
    del dexpr
    obj.tumor_subclusters = res

    subclusters_per_chr = None
    if per_chr_hmm_subclusters and partition_method == "leiden":
        if not per_chr_hmm_subclusters_references:
            if cluster_by_groups:
                groups_for_chr = {k: np.asarray(v) for k, v in obj.obs_groups.items()}
            else:
                groups_for_chr = {"all_observations": obj.all_obs_idx()}
        else:
            groups_for_chr = tumor_groups
        subclusters_per_chr = {}
        chr_ids = obj.gene_order.chr_ids[keep_genes]
        for ci, cname in enumerate(obj.gene_order.chr_names):
            gsel = np.nonzero(chr_ids == ci)[0]
            chr_map: Dict[str, np.ndarray] = {}
            for group, idx in groups_for_chr.items():
                c_data = expr[np.ix_(idx, gsel)]
                n = idx.shape[0]
                if n < 3 or k_nn >= n or gsel.size == 0:
                    chr_map[group] = idx
                    continue
                part = _leiden_partition(
                    c_data, k_nn, leiden_resolution_per_chr,
                    leiden_method_per_chr, leiden_function_per_chr, seed + ci,
                    device=dev,
                )
                for lab in np.unique(part):
                    chr_map[f"{group}_s{lab+1}"] = idx[part == lab]
            if not per_chr_hmm_subclusters_references:
                chr_map.update({k: np.asarray(v) for k, v in obj.ref_groups.items()})
            subclusters_per_chr[cname] = chr_map

    if PHASE_TIMES:
        log_info("-subcluster phases: " + " ".join(
            f"{k}={v:.1f}s" for k, v in sorted(PHASE_TIMES.items(),
                                               key=lambda kv: -kv[1])))
    if obj.hspike is not None:
        log_info("-mirroring subclusters for hspike (partition_method='none')")
        phases, rss = dict(PHASE_TIMES), dict(PHASE_RSS_GB)  # the call clears them
        define_tumor_subclusters(obj.hspike, cluster_by_groups=True,
                                 partition_method="none", z_score_filter=0.0,
                                 device=dev)
        PHASE_TIMES.clear()
        PHASE_TIMES.update(phases)
        PHASE_RSS_GB.clear()
        PHASE_RSS_GB.update(rss)
    ROWS_FROM = rows_from
    return subclusters_per_chr
