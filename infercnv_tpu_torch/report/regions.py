"""CNV region calling and report files.

reference: R/inferCNV_HMM.R — consensus state per gene over a cell group
(.get_state_consensus :977-987), run-length segmentation into regions per
chromosome (.define_cnv_gene_regions :1005-1057, bounds :1071-1087), report
writers (generate_cnv_region_reports :790-869) producing
``.cell_groupings``, ``.pred_cnv_regions.dat``, ``.pred_cnv_genes.dat`` and
``.genes_used.dat``.

Copied from infercnv_tpu/report/regions.py (all of it): host numpy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from infercnv_tpu_torch.core.genome import GeneOrder
from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.utils.logging import log_info, log_warn


@dataclasses.dataclass
class CnvRegion:
    name: str                 # e.g. "chr1-region_3"
    state: int
    chrom: str
    start: int
    end: int
    genes: List[str]
    gene_states: List[int]
    gene_starts: List[int]
    gene_stops: List[int]


@dataclasses.dataclass
class GroupRegions:
    group_name: str
    cells: List[str]
    regions: List[CnvRegion]


def state_consensus(states_cg: np.ndarray,
                    weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Majority-vote state per gene across cells; ties -> smallest state
    (reference .get_state_consensus :977-987 — R table() ordering gives the
    numerically smallest label on ties).  states_cg: [C, G] 1-based.
    weights: optional per-row multiplicities (factorized group states)."""
    states = np.asarray(states_cg)  # int8 at scale; never widen the matrix
    S = int(states.max()) if states.size else 1
    counts = np.zeros((S, states.shape[1]), np.int64)
    for s in range(1, S + 1):
        eq = states == s
        counts[s - 1] = (weights[:, None] * eq).sum(axis=0) if weights is not None \
            else eq.sum(axis=0)
    return counts.argmax(axis=0) + 1


def define_cnv_gene_regions(consensus: np.ndarray, gene_order: GeneOrder,
                            counter_start: int = 0) -> Tuple[List[CnvRegion], int]:
    """Run-length segmentation per chromosome
    (reference .define_cnv_gene_regions :1005-1057; chromosomes with < 2
    genes are skipped)."""
    regions: List[CnvRegion] = []
    counter = counter_start
    for ci, (b, e) in enumerate(gene_order.chr_ranges()):
        if e - b < 2:
            continue
        chrom = gene_order.chr_names[ci]
        seg_start = b
        prev_state = int(consensus[b])
        for g in range(b + 1, e + 1):
            state = int(consensus[g]) if g < e else None
            if state != prev_state:
                counter += 1
                idx = list(range(seg_start, g))
                regions.append(CnvRegion(
                    name=f"{chrom}-region_{counter}",
                    state=prev_state,
                    chrom=chrom,
                    start=int(gene_order.start[idx].min()),
                    end=int(gene_order.stop[idx].max()),
                    genes=[gene_order.names[i] for i in idx],
                    gene_states=[prev_state] * len(idx),
                    gene_starts=[int(gene_order.start[i]) for i in idx],
                    gene_stops=[int(gene_order.stop[i]) for i in idx],
                ))
                seg_start = g
                prev_state = state
    return regions, counter


def get_predicted_cnv_regions(obj: InferCNV, states_cg: np.ndarray,
                              by: str = "subcluster") -> List[GroupRegions]:
    """reference get_predicted_CNV_regions :706-764."""
    if by == "subcluster" and (obj.tumor_subclusters is None):
        log_warn("no subclusters defined, resetting reporting mode to consensus")
        by = "consensus"

    cell_groups: Dict[str, np.ndarray] = {}
    if by == "consensus":
        cell_groups.update({k: np.asarray(v) for k, v in obj.ref_groups.items()})
        cell_groups.update({k: np.asarray(v) for k, v in obj.obs_groups.items()})
    elif by == "subcluster":
        for _grp, subs in obj.tumor_subclusters["subclusters"].items():
            for sub_name, idx in subs.items():
                cell_groups[sub_name] = np.asarray(idx)
    elif by == "cell":
        for idx in list(obj.ref_groups.values()) + list(obj.obs_groups.values()):
            for i in np.asarray(idx):
                cell_groups[obj.cell_names[i]] = np.array([i])
    else:
        raise ValueError(f"unknown region reporting mode: {by}")

    factorized = hasattr(states_cg, "cell_to_row")  # models.hmm.GroupedStates
    out: List[GroupRegions] = []
    counter = 0
    for name, idx in cell_groups.items():
        if factorized:
            # group-mode calls are constant per group: vote over the few
            # DISTINCT state rows weighted by their multiplicity instead of
            # expanding [C, G]
            ids = states_cg.cell_to_row[idx]
            uniq, cnt = np.unique(ids, return_counts=True)
            consensus = state_consensus(states_cg.rows[uniq], weights=cnt)
        else:
            consensus = state_consensus(states_cg[idx])
        regions, counter = define_cnv_gene_regions(consensus, obj.gene_order, counter)
        out.append(GroupRegions(
            group_name=name,
            cells=[obj.cell_names[i] for i in idx],
            regions=regions,
        ))
    return out


def generate_cnv_region_reports(
    obj: InferCNV,
    states_cg: np.ndarray,
    output_filename_prefix: str,
    out_dir: str,
    ignore_neutral_state: Optional[int] = None,
    by: str = "subcluster",
) -> List[GroupRegions]:
    """Write the four report files (reference generate_cnv_region_reports
    :790-869) and return the region structures."""
    os.makedirs(out_dir, exist_ok=True)
    group_regions = get_predicted_cnv_regions(obj, states_cg, by)

    cg_path = os.path.join(out_dir, f"{output_filename_prefix}.cell_groupings")
    with open(cg_path, "w") as f:
        f.write("cell_group_name\tcell\n")
        for gr in group_regions:
            for cell in gr.cells:
                f.write(f"{gr.group_name}\t{cell}\n")
    log_info(f"-wrote cell clusters file: {cg_path}")

    reg_path = os.path.join(out_dir, f"{output_filename_prefix}.pred_cnv_regions.dat")
    with open(reg_path, "w") as f:
        f.write("cell_group_name\tcnv_name\tstate\tchr\tstart\tend\n")
        for gr in group_regions:
            for r in gr.regions:
                if ignore_neutral_state is not None and r.state == ignore_neutral_state:
                    continue
                f.write(f"{gr.group_name}\t{r.name}\t{r.state}\t{r.chrom}\t{r.start}\t{r.end}\n")
    log_info(f"-wrote cnv regions file: {reg_path}")

    genes_path = os.path.join(out_dir, f"{output_filename_prefix}.pred_cnv_genes.dat")
    with open(genes_path, "w") as f:
        f.write("cell_group_name\tgene_region_name\tstate\tgene\tchr\tstart\tend\n")
        for gr in group_regions:
            for r in gr.regions:
                if ignore_neutral_state is not None and r.state == ignore_neutral_state:
                    continue
                for g, s, st, sp in zip(r.genes, r.gene_states, r.gene_starts, r.gene_stops):
                    f.write(f"{gr.group_name}\t{r.name}\t{s}\t{g}\t{r.chrom}\t{st}\t{sp}\n")
    log_info(f"-wrote per-gene cnv report: {genes_path}")

    order_path = os.path.join(out_dir, f"{output_filename_prefix}.genes_used.dat")
    go = obj.gene_order
    with open(order_path, "w") as f:
        f.write("\tchr\tstart\tstop\n")
        for i, name in enumerate(go.names):
            f.write(f"{name}\t{go.chr_names[go.chr_ids[i]]}\t{go.start[i]}\t{go.stop[i]}\n")
    log_info(f"-wrote gene ordering info: {order_path}")
    return group_regions


def write_expr_matrix(path: str, expr_cg: np.ndarray, gene_order: GeneOrder,
                      cell_names: Sequence[str], cell_idx: np.ndarray) -> None:
    """Write a [genes x cells] tab matrix in the reference's text format
    (e.g. infercnv.observations.txt)."""
    idx = np.asarray(cell_idx)
    sub = np.asarray(expr_cg)[idx].T.astype(np.float64)  # [G, |idx|]
    rows = sub.tolist()  # bulk-convert: ~5x faster than per-element float()
    with open(path, "w") as f:
        # R write.table default: space-separated THROUGHOUT, quoted names
        # (the header was tab-joined before — a mixed-separator file no
        # single-separator parser could read)
        f.write(" ".join(f'"{cell_names[i]}"' for i in idx) + "\n")
        for g, row in enumerate(rows):
            f.write('"' + gene_order.names[g] + '" ' + " ".join(map(repr, row)) + "\n")
