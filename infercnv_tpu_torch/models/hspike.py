"""The hidden spike-in ("hspike"), a synthetic calibration dataset.

Counterpart of infercnv_tpu/models/hspike.py: ``hspike_chr_info`` is a copy,
and ``build_hspike`` and ``sim_foreground`` follow the reference's steps with
the draws taken from one ``torch.Generator`` on the CPU, seeded from
``seed`` whatever device the run uses, where the reference splits
``jax.random`` keys.  The spike is small (200 cells a normal group), so a
run on the card and a run on the CPU build the same hspike.  The draws
agree with the reference's in distribution only; everything after them is
the reference's numpy.  ``sim_method="splatter"`` estimates its
parameters from the normal cells' raw counts and draws through
sim/splatter.py, as the reference's branches do (:170-179, :239-263).

reference: R/inferCNV_hidden_spike.R (.build_and_add_hspike :3-165,
.get_hspike_chr_info :170-215).  A fake genome of 11 chromosomes alternates
neutral regions with CNV levels {0.01, 0.5, 1.5, 2, 3}; per reference group,
100 'simnorm' cells and 100 'spike_tumor' cells are simulated from gene
means sampled off the real normal cells, with CNV chromosomes' means
multiplied by the CNV factor.  The hspike object then rides through every
pipeline op exactly like the real data, and the residual intensities of its
spiked chromosomes calibrate the i6 HMM emissions.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from infercnv_tpu_torch.core.genome import GeneOrder
from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.ops.transforms import normalize_counts_by_seq_depth
from infercnv_tpu_torch.sim.meanvar import (
    fit_dropout_spline,
    fit_mean_var_spline,
    get_mean_var_table,
    get_mean_vs_p0_table,
    group_stats_single_pass,
    simulate_meanvar_counts,
    simulate_simple_counts,
)
from infercnv_tpu_torch.utils.logging import log_info

HSPIKE_NUM_CELLS = 100
HSPIKE_GENES_PER_CHR = 400


def _unknown_sim(sim_method: str) -> ValueError:
    return ValueError(f"sim_method {sim_method!r} not supported "
                      "(use meanvar/simple/splatter)")


def hspike_chr_info(num_genes_each: int, num_total: int) -> List[Tuple[str, float, int]]:
    """(name, cnv_level, ngenes) per fake chromosome
    (reference .get_hspike_chr_info :170-215)."""
    num_remaining = num_total - 10 * num_genes_each
    if num_remaining < num_genes_each:
        num_remaining = num_genes_each
    return [
        ("chrA", 1.0, num_genes_each),
        ("chr_0", 0.01, num_genes_each),
        ("chr_B", 1.0, num_genes_each),
        ("chr_0pt5", 0.5, num_genes_each),
        ("chr_C", 1.0, num_genes_each),
        ("chr_1pt5", 1.5, num_genes_each),
        ("chr_D", 1.0, num_genes_each),
        ("chr_2pt0", 2.0, num_genes_each),
        ("chr_E", 1.0, num_genes_each),
        ("chr_3pt0", 3.0, num_genes_each),
        ("chr_F", 1.0, num_remaining),
    ]


def build_hspike(
    obj: InferCNV,
    sim_method: str = "meanvar",
    aggregate_normals: bool = False,
    seed: int = 12345,
    common_dispersion=0.1,
    normalize_factor: float = None,
) -> InferCNV:
    """Build the hspike child object from `obj` (whose expr must already be
    depth-normalized, as in run() step 3 — reference inferCNV_ops.R:588-590).

    normalize_factor: when set, obj.expr holds RAW counts and the depth
    normalization is applied on the fly inside the single statistics pass
    (the engine fast path keeps counts raw and normalizes on device, so
    run() never materializes the normalized matrix on host).

    common_dispersion (sim_method='simple' only): NB dispersion for the
    count simulation.  The reference's live path hardcodes 0.1
    (inferCNV_hidden_spike.R:86,123) and ships an edgeR::estimateDisp
    wrapper it never calls (inferCNV_simple_sim.R:227-240); pass 'auto'
    here to actually estimate it from the normal cells (one-parameter NB
    profile MLE, sim/meanvar.estimate_common_dispersion).
    """
    log_info("Adding h-spike")
    if obj.has_reference_cells():
        if aggregate_normals:
            normal_lists = {"normalsToUse": obj.all_ref_idx()}
        else:
            normal_lists = {k: np.asarray(v) for k, v in obj.ref_groups.items()}
    else:
        normal_lists = {"normalsToUse": obj.all_obs_idx()}
        log_info("-no normals defined, using all observation cells as proxy")

    chr_info = hspike_chr_info(HSPIKE_GENES_PER_CHR, obj.num_genes)
    chr_names = tuple(c[0] for c in chr_info)
    chr_ids = np.concatenate([np.full(c[2], i, np.int32) for i, c in enumerate(chr_info)])
    starts = np.concatenate([np.arange(1, c[2] + 1) for c in chr_info])
    num_genes = chr_ids.shape[0]
    gene_order = GeneOrder(
        names=tuple(f"gene_{i+1}" for i in range(num_genes)),
        chr_names=chr_names, chr_ids=chr_ids, start=starts, stop=starts,
    )
    cnv_factor = np.concatenate(
        [np.full(c[2], c[1], np.float64) for c in chr_info]
    )

    if sim_method not in ("meanvar", "simple", "splatter"):
        raise _unknown_sim(sim_method)
    gen = torch.Generator().manual_seed(int(seed))
    genes_means_use_idx = torch.randint(
        0, obj.num_genes, (num_genes,), generator=gen).numpy()

    # mean-variance / dropout trends from ALL cell groups of the real object
    # (reference .get_mean_var_table via the full infercnv_obj).  One chunked
    # read pass computes every group statistic this builder needs — the
    # per-group gathers it replaces wrote ~7 GB of copies at 100k cells.
    all_groups = list(obj.obs_groups.values()) + list(obj.ref_groups.values())
    (all_stats, normal_stats), libsizes = group_stats_single_pass(
        obj.expr, [all_groups, list(normal_lists.values())],
        normalize_factor=normalize_factor)
    a_means, a_vars, a_p0 = all_stats
    mv_spline = fit_mean_var_spline(a_means.ravel(), a_vars.ravel())
    dropout_spline = fit_dropout_spline(a_means.ravel(), a_p0.ravel())
    n_means, _n_vars, _n_p0 = normal_stats

    sim_blocks: List[np.ndarray] = []
    ref_groups: Dict[str, np.ndarray] = {}
    obs_groups: Dict[str, np.ndarray] = {}
    cell_names: List[str] = []
    cell_counter = 0
    median_norm_libsize = None

    for ni, (normal_type, normal_idx) in enumerate(normal_lists.items()):
        log_info(f"-hspike modeling of {normal_type}")
        gene_means = n_means[ni].astype(np.float32)[genes_means_use_idx]
        gene_means = np.where(gene_means == 0, 1e-3, gene_means)
        if median_norm_libsize is None:
            # every row of a depth-normalized matrix sums to the factor
            median_norm_libsize = (
                float(normalize_factor) if normalize_factor is not None
                else float(np.median(libsizes[np.asarray(normal_idx)])))

        hspike_gene_means = gene_means * cnv_factor

        if sim_method == "meanvar":
            sim_norm = simulate_meanvar_counts(gen, gene_means, mv_spline,
                                               HSPIKE_NUM_CELLS, dropout_spline)
            sim_tumor = simulate_meanvar_counts(gen, hspike_gene_means, mv_spline,
                                                HSPIKE_NUM_CELLS, dropout_spline)
        elif sim_method == "simple":
            if common_dispersion == "auto":
                # estimated PER normal group (a local, never rebinding the
                # parameter — else group B would silently reuse group A's
                # dispersion)
                from infercnv_tpu_torch.sim.meanvar import estimate_common_dispersion

                sl = obj.expr[np.asarray(normal_idx)]
                if normalize_factor is not None:
                    sl = sl / np.maximum(sl.sum(axis=1, keepdims=True), 1e-12) \
                        * normalize_factor
                disp = float(estimate_common_dispersion(sl.T))
                log_info(f"-estimated NB common dispersion for "
                         f"{normal_type}: {disp:g}")
            else:
                disp = float(common_dispersion)
            sim_norm = simulate_simple_counts(gen, gene_means, HSPIKE_NUM_CELLS,
                                              disp, dropout_spline)
            sim_tumor = simulate_simple_counts(gen, hspike_gene_means, HSPIKE_NUM_CELLS,
                                               disp, dropout_spline)
        else:
            from infercnv_tpu_torch.sim import splatter

            sp = splatter.estimate_splatter_params(obj.counts[np.asarray(normal_idx)].T)
            sp.nGenes, sp.nCells = num_genes, HSPIKE_NUM_CELLS
            sim_norm = splatter.simulate_splatter_counts(
                gen, sp, gene_means, HSPIKE_NUM_CELLS)
            sim_tumor = splatter.simulate_splatter_counts(
                gen, sp, hspike_gene_means, HSPIKE_NUM_CELLS)

        norm_name = f"simnorm_cell_{normal_type}"
        tumor_name = f"spike_tumor_cell_{normal_type}"
        sim_blocks.append(sim_norm.numpy())
        sim_blocks.append(sim_tumor.numpy())
        ref_groups[norm_name] = np.arange(cell_counter, cell_counter + HSPIKE_NUM_CELLS)
        cell_names += [f"{norm_name}{i+1}" for i in range(HSPIKE_NUM_CELLS)]
        cell_counter += HSPIKE_NUM_CELLS
        obs_groups[tumor_name] = np.arange(cell_counter, cell_counter + HSPIKE_NUM_CELLS)
        cell_names += [f"{tumor_name}{i+1}" for i in range(HSPIKE_NUM_CELLS)]
        cell_counter += HSPIKE_NUM_CELLS

    counts = np.concatenate(sim_blocks, axis=0).astype(np.float32)  # [C_spike, G]
    hspike = InferCNV(
        expr=counts,
        counts=counts.copy(),
        gene_order=gene_order,
        cell_names=cell_names,
        ref_groups=ref_groups,
        obs_groups=obs_groups,
    )
    hspike.validate()
    # same target counts/cell as the real normals (reference :160)
    hspike.expr = np.asarray(
        normalize_counts_by_seq_depth(hspike.expr, median_norm_libsize)
    )
    return hspike


def sim_foreground(obj: InferCNV, sim_method: str = "meanvar",
                   seed: int = 12345) -> None:
    """Replace EVERY cell group's expression with counts simulated from the
    group's own gene means — the reference's developer/debug option
    (.sim_foreground, R/inferCNV_hidden_spike.R:219-281; gated by
    run(sim_foreground=TRUE), R/inferCNV_ops.R:592-593).

    obj.expr must be depth-normalized (run() step 3); afterwards the matrix
    is re-normalized to the median normal-cell library size (:280).
    Mutates obj in place."""
    log_info("## simulating foreground")
    expr = np.asarray(obj.expr)
    normal_idx = obj.all_ref_idx() if obj.has_reference_cells() else obj.all_obs_idx()
    target = float(np.median(expr[normal_idx].sum(axis=1)))
    groups = {**obj.obs_groups, **obj.ref_groups}

    mv_spline = dropout_spline = None
    if sim_method == "meanvar":
        all_groups = list(obj.obs_groups.values()) + list(obj.ref_groups.values())
        m_tab, v_tab = get_mean_var_table(expr, all_groups)
        mv_spline = fit_mean_var_spline(m_tab, v_tab)
        m0, p0 = get_mean_vs_p0_table(expr, all_groups)
        dropout_spline = fit_dropout_spline(m0, p0)
    elif sim_method == "simple":
        # reference builds the mean->P(0) table from the NORMAL cells only
        m0, p0 = get_mean_vs_p0_table(expr, [normal_idx])
        dropout_spline = fit_dropout_spline(m0, p0)
    elif sim_method == "splatter":
        from infercnv_tpu_torch.sim import splatter

        sp = splatter.estimate_splatter_params(obj.counts[np.asarray(normal_idx)].T)
    else:
        raise _unknown_sim(sim_method)

    gen = torch.Generator().manual_seed(int(seed) + 219)  # not the hspike's stream
    out = expr.copy()
    for name, idx in groups.items():
        idx = np.asarray(idx)
        gene_means = expr[idx].mean(axis=0)
        gene_means = np.where(gene_means == 0, 1e-3, gene_means)
        if sim_method == "meanvar":
            sim = simulate_meanvar_counts(gen, gene_means, mv_spline,
                                          idx.size, dropout_spline)
        elif sim_method == "simple":
            sim = simulate_simple_counts(gen, gene_means, idx.size, 0.1,
                                         dropout_spline)
        else:
            sp.nCells = idx.size
            sim = splatter.simulate_splatter_counts(gen, sp, gene_means, idx.size)
        out[idx] = np.asarray(sim)
    obj.expr = np.asarray(normalize_counts_by_seq_depth(out, target))
