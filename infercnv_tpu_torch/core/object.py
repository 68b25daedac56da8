"""The InferCNV data object.

Copied from infercnv_tpu/core/object.py (``InferCNV``, lines 29-162, and
``create_infercnv_object``, lines 164-287), which is plain numpy.  The
object stays numpy on the host, as the reference keeps it; the pipeline
moves rows to the card only inside the steps that compute there.

Analogue of the reference's S4 ``infercnv`` class
(reference: R/inferCNV.R:37-47) and ``CreateInfercnvObject``
(R/inferCNV.R:133-337).  Canonical array layout is ``[cells, genes]``
float32 (cells-major); the reference keeps [genes, cells] and all file I/O
transposes at the boundary.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from infercnv_tpu_torch.core.genome import GeneOrder, order_reduce
from infercnv_tpu_torch.utils.logging import log_info, log_warn
from infercnv_tpu_torch.utils.memmap import read_rows


CellGroups = Dict[str, np.ndarray]  # group name -> int32 cell indices


def _take_columns(x: np.ndarray, cols: np.ndarray, block_rows: int = 16384) -> np.ndarray:
    """np.take(x, cols, axis=1) as a new matrix, taken in row blocks (a
    disk memmap's rows read through its file, utils/memmap.py).  np.take
    is ~4x faster than fancy column indexing for wide row-major matrices
    (measured: 21s vs 86s at 100k x 10k)."""
    out = np.empty((x.shape[0], cols.size), x.dtype)
    for b in range(0, x.shape[0], block_rows):
        np.take(read_rows(x, b, b + block_rows), cols, axis=1, out=out[b:b + block_rows])
    return out


@dataclasses.dataclass
class InferCNV:
    """Mutable pipeline state.

    Attributes:
      expr: float32 [C, G] working expression data (rewritten by each step —
        mirrors infercnv_obj@expr.data).
      counts: float32 [C, G] raw counts, preserved (mirrors @count.data).
      gene_order: GeneOrder for the gene axis.
      cell_names: list of C cell names.
      ref_groups: reference ("normal") cell groups, name -> indices.
      obs_groups: observation (tumor) cell groups, name -> indices.
      tumor_subclusters: optional nested subcluster assignment
        {"subclusters": {group: {subcluster_name: indices}}, "hc": {group: linkage}}.
      hspike: optional child InferCNV holding the simulated hidden spike-in;
        every pipeline op is mirrored onto it (reference invariant, e.g.
        R/inferCNV_ops.R:1695-1698).
      options: creation/run options recorded for checkpoint compatibility.
    """

    expr: np.ndarray
    counts: Optional[np.ndarray]  # None after a scale run releases raw counts
    gene_order: GeneOrder
    cell_names: List[str]
    ref_groups: CellGroups
    obs_groups: CellGroups
    tumor_subclusters: Optional[dict] = None
    hspike: Optional["InferCNV"] = None
    options: dict = dataclasses.field(default_factory=dict)

    # ---------------- basic introspection ----------------

    @property
    def num_cells(self) -> int:
        return self.expr.shape[0]

    @property
    def num_genes(self) -> int:
        return self.expr.shape[1]

    def has_reference_cells(self) -> bool:
        """reference: has_reference_cells (R/inferCNV.R:526-528)."""
        return len(self.ref_groups) > 0

    def all_ref_idx(self) -> np.ndarray:
        if not self.ref_groups:
            return np.zeros((0,), np.int64)
        return np.concatenate([np.asarray(v) for v in self.ref_groups.values()])

    def all_obs_idx(self) -> np.ndarray:
        if not self.obs_groups:
            return np.zeros((0,), np.int64)
        return np.concatenate([np.asarray(v) for v in self.obs_groups.values()])

    def validate(self) -> None:
        """reference: validate_infercnv_obj (R/inferCNV.R:471-505)."""
        C, G = self.expr.shape
        if self.counts is None:
            # a scale run may release the raw counts after the engine pass
            # (runner/pipeline.py); views built from such an object are valid
            pass
        elif self.counts.shape[0] != C:
            raise ValueError(
                f"counts has {self.counts.shape[0]} cells but expr has {C}")
        if (self.counts is not None and self.counts.shape[1] != G
                and self.counts.shape != self.expr.shape):
            # counts keeps the full gene set only at creation; after gene
            # removal both are subset together (remove_genes, R/inferCNV.R:445)
            raise ValueError("expr and counts shapes inconsistent")
        if self.gene_order.num_genes != G:
            raise ValueError("gene_order does not match expr gene axis")
        if len(self.cell_names) != C:
            raise ValueError("cell_names does not match expr cell axis")
        seen = np.zeros(C, np.int64)
        for grp in (self.ref_groups, self.obs_groups):
            for name, idx in grp.items():
                idx = np.asarray(idx)
                if idx.size and (idx.min() < 0 or idx.max() >= C):
                    raise ValueError(f"cell group {name} has out-of-range indices")
                seen[idx] += 1
        if np.any(seen > 1):
            raise ValueError("cell assigned to more than one group")

    # ---------------- mutation helpers ----------------

    def remove_genes(self, remove_idx: np.ndarray) -> "InferCNV":
        """Drop genes by index from expr, counts and gene_order
        (reference: remove_genes R/inferCNV.R:445-457)."""
        remove_idx = np.asarray(remove_idx)
        keep = np.ones(self.num_genes, bool)
        if remove_idx.size:
            keep[remove_idx] = False
        keep_idx = np.nonzero(keep)[0]
        counts_was_expr = self.counts is not None and self.counts is self.expr
        self.expr = _take_columns(self.expr, keep_idx)
        if counts_was_expr:
            self.counts = self.expr
        elif self.counts is not None and self.counts.shape[1] == keep.shape[0]:
            self.counts = _take_columns(self.counts, keep_idx)
        self.gene_order = self.gene_order.subset(keep_idx)
        return self

    def copy(self) -> "InferCNV":
        return InferCNV(
            expr=self.expr.copy(),
            counts=self.counts,
            gene_order=self.gene_order,
            cell_names=list(self.cell_names),
            ref_groups={k: np.asarray(v).copy() for k, v in self.ref_groups.items()},
            obs_groups={k: np.asarray(v).copy() for k, v in self.obs_groups.items()},
            tumor_subclusters=self.tumor_subclusters,
            hspike=self.hspike.copy() if self.hspike is not None else None,
            options=dict(self.options),
        )

    def shallow_copy(self) -> "InferCNV":
        """Copy the structure but SHARE the expr/counts arrays.

        For rebind-only consumers (run() replaces expr wholesale at every
        step and never writes into the shared buffer) this skips a full
        matrix copy — ~4 GB of memory writes at 100k cells."""
        return InferCNV(
            expr=self.expr,
            counts=self.counts,
            gene_order=self.gene_order,
            cell_names=list(self.cell_names),
            ref_groups={k: np.asarray(v).copy() for k, v in self.ref_groups.items()},
            obs_groups={k: np.asarray(v).copy() for k, v in self.obs_groups.items()},
            tumor_subclusters=self.tumor_subclusters,
            hspike=self.hspike.copy() if self.hspike is not None else None,
            options=dict(self.options),
        )


def create_infercnv_object(
    counts_matrix: np.ndarray,
    gene_names: Sequence[str],
    cell_names: Sequence[str],
    annotations: Dict[str, str],
    gene_order_table: Dict[str, Tuple[str, int, int]],
    chr_file_order: Sequence[str],
    ref_group_names: Optional[Sequence[str]] = None,
    chr_exclude: Sequence[str] = ("chrX", "chrY", "chrM"),
    min_max_counts_per_cell: Tuple[float, float] = (100.0, np.inf),
    max_cells_per_group: Optional[int] = None,
    seed: int = 0,
) -> InferCNV:
    """Build an InferCNV object from parsed inputs.

    Mirrors ``CreateInfercnvObject`` (reference R/inferCNV.R:133-337):
    excludes chromosomes in `chr_exclude`, requires every annotated cell to be
    in the matrix, genomically orders genes (``.order_reduce``), filters cells
    by total counts in ``min_max_counts_per_cell``, optionally subsamples
    ``max_cells_per_group``, and splits cells into reference/observation
    groups (observation group names sorted, R/inferCNV.R:291-312).

    Args:
      counts_matrix: [G, C] raw counts (genes x cells, as read from file).
      annotations: cell name -> group name.
      gene_order_table: gene -> (chr, start, stop).
      chr_file_order: unique chromosome names in gene-order-file order.
    """
    try:  # accept scipy sparse (dgCMatrix analogue, reference :146-165)
        import scipy.sparse as sp

        if sp.issparse(counts_matrix):
            counts_matrix = counts_matrix.toarray()
    except ImportError:
        pass
    counts_matrix = np.asarray(counts_matrix, np.float64)
    gene_names = list(gene_names)
    cell_names = list(cell_names)

    # exclude chromosomes (reference :168-181)
    excl = set(chr_exclude or ())
    chr_order = [c for c in chr_file_order if c not in excl]
    gene_order_table = {
        g: v for g, v in gene_order_table.items() if v[0] not in excl
    }

    # all annotated cells must exist in the matrix (reference :201-210)
    matrix_cells = set(cell_names)
    missing = [c for c in annotations if c not in matrix_cells]
    if missing:
        raise ValueError(
            "Please make sure that all the annotated cell names match a "
            f"sample in your data matrix. Missing (n={len(missing)}): {missing[:10]}"
        )

    # restrict matrix to annotated cells, in matrix order
    ann_cell_idx = [i for i, c in enumerate(cell_names) if c in annotations]
    cell_names = [cell_names[i] for i in ann_cell_idx]
    counts_matrix = counts_matrix[:, ann_cell_idx]

    # genomic ordering (reference :213, 352-428)
    expr, go, _rows = order_reduce(counts_matrix, gene_names, gene_order_table, chr_order)

    # cell total-count filter (reference :236-256)
    lo, hi = min_max_counts_per_cell
    cs = expr.sum(axis=0)
    keep_cells = (cs >= lo) & (cs <= hi)
    if not np.all(keep_cells):
        log_warn(f"Removing {int((~keep_cells).sum())} cells with counts outside [{lo}, {hi}]")
        idx = np.nonzero(keep_cells)[0]
        expr = expr[:, idx]
        cell_names = [cell_names[i] for i in idx]
    if len(cell_names) == 0:
        raise ValueError(
            "All cells were removed by the min/max counts-per-cell filter "
            f"{(lo, hi)}; check your counts matrix scale."
        )

    # optional per-group subsampling (reference :269-282)
    groups: Dict[str, List[int]] = {}
    for i, c in enumerate(cell_names):
        groups.setdefault(annotations[c], []).append(i)
    if max_cells_per_group is not None:
        rng = np.random.default_rng(seed)
        sel: List[int] = []
        for gname, idx in groups.items():
            if len(idx) > max_cells_per_group:
                log_info(f"Downsampling group {gname} from {len(idx)} to {max_cells_per_group}")
                idx = sorted(rng.choice(idx, size=max_cells_per_group, replace=False).tolist())
            sel.extend(idx)
        sel = sorted(sel)
        expr = expr[:, sel]
        cell_names = [cell_names[i] for i in sel]
        groups = {}
        for i, c in enumerate(cell_names):
            groups.setdefault(annotations[c], []).append(i)

    # split ref/obs groups (reference :291-312); obs = sorted setdiff
    ref_group_names = list(ref_group_names or [])
    for r in ref_group_names:
        if r not in groups:
            raise ValueError(f"reference group {r!r} not found in annotations")
    obs_names = sorted(g for g in groups if g not in ref_group_names)
    ref_groups = {g: np.asarray(groups[g], np.int64) for g in ref_group_names}
    obs_groups = {g: np.asarray(groups[g], np.int64) for g in obs_names}

    expr_cg = np.ascontiguousarray(expr.T, np.float32)  # [C, G] canonical
    md5 = hashlib.md5(np.ascontiguousarray(expr).tobytes()).hexdigest()

    obj = InferCNV(
        expr=expr_cg,
        counts=expr_cg.copy(),
        gene_order=go,
        cell_names=cell_names,
        ref_groups=ref_groups,
        obs_groups=obs_groups,
        options={"counts_md5": md5, "chr_exclude": tuple(chr_exclude or ())},
    )
    obj.validate()
    log_info(
        f"Created InferCNV object: {obj.num_genes} genes x {obj.num_cells} cells; "
        f"{len(ref_groups)} reference group(s), {len(obs_groups)} observation group(s)"
    )
    return obj
