"""Bundled datasets — analogues of the reference's packaged data objects
(reference R/data.R:1-43: infercnv_data_example, HMM_states, mcmc_obj) and
its extdata example.

Copied from infercnv_tpu/data.py (numpy only)."""

from __future__ import annotations

import numpy as np

from infercnv_tpu_torch.core.object import InferCNV, create_infercnv_object
from infercnv_tpu_torch.io.loaders import load_bundled_example  # noqa: F401


def synthetic_example(seed: int = 7, n_normal: int = 30, n_tumor: int = 30,
                      genes_per_chr: int = 60, n_chr: int = 4,
                      del_factor: float = 0.5, amp_factor: float = 2.0) -> InferCNV:
    """Small synthetic dataset with a planted chr2 deletion and chr3
    amplification in the tumor cells — the quick-start analogue of
    infercnv_data_example."""
    if n_chr < 3:
        raise ValueError("synthetic_example plants CNVs on chr2 and chr3; "
                         "n_chr must be >= 3 (the slices would silently "
                         "fall out of range otherwise)")
    rng = np.random.default_rng(seed)
    G = genes_per_chr * n_chr
    base = rng.gamma(2.0, 50.0, G)
    C = n_normal + n_tumor
    factor = np.ones((C, G))
    tumor = slice(n_normal, C)
    factor[tumor, genes_per_chr:2 * genes_per_chr] = del_factor
    factor[tumor, 2 * genes_per_chr:3 * genes_per_chr] = amp_factor
    counts = rng.poisson(factor * base[None, :]).astype(np.float64).T
    gene_names = [f"g{i}" for i in range(G)]
    cell_names = [f"n{i}" for i in range(n_normal)] + [f"t{i}" for i in range(n_tumor)]
    ann = {c: ("normal" if c.startswith("n") else "tumor") for c in cell_names}
    table = {
        f"g{i}": (f"chr{i // genes_per_chr + 1}",
                  (i % genes_per_chr) * 1000 + 1,
                  (i % genes_per_chr) * 1000 + 501)
        for i in range(G)
    }
    return create_infercnv_object(
        counts_matrix=counts, gene_names=gene_names, cell_names=cell_names,
        annotations=ann, gene_order_table=table,
        chr_file_order=[f"chr{i+1}" for i in range(n_chr)],
        ref_group_names=["normal"], chr_exclude=(),
        min_max_counts_per_cell=(1, np.inf),
    )
