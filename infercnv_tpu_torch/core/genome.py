"""Gene-order / genome model.

Copied from infercnv_tpu/core/genome.py (``GeneOrder``, lines 19-94, and
``order_reduce``, lines 97-136), which is plain numpy; the port keeps its own copy so that it never imports the JAX
package.

The reference stores a ``gene_order`` data.frame (chr factor, start, stop) in
genomic order alongside the expression matrix (reference: R/inferCNV.R:37-47,
``.order_reduce`` R/inferCNV.R:352-428).  Here the same information is a
dense, static description: an integer ``chr_ids[G]`` segment array plus
per-chromosome [begin, end) ranges.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GeneOrder:
    """Genomic ordering of the gene axis.

    Attributes:
      names: gene names, length G, in genomic order.
      chr_names: unique chromosome names in their order of appearance
        (mirrors the R chr factor levels taken from file order).
      chr_ids: int32[G], index into chr_names for each gene.
      start: int64[G] genomic start coordinates.
      stop: int64[G] genomic stop coordinates.
    """

    names: Tuple[str, ...]
    chr_names: Tuple[str, ...]
    chr_ids: np.ndarray
    start: np.ndarray
    stop: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "chr_ids", np.asarray(self.chr_ids, np.int32))
        object.__setattr__(self, "start", np.asarray(self.start, np.int64))
        object.__setattr__(self, "stop", np.asarray(self.stop, np.int64))
        if not (len(self.names) == self.chr_ids.shape[0] == self.start.shape[0] == self.stop.shape[0]):
            raise ValueError("GeneOrder fields must have equal length")

    @property
    def num_genes(self) -> int:
        return len(self.names)

    @property
    def num_chrs(self) -> int:
        return len(self.chr_names)

    def chr_ranges(self) -> List[Tuple[int, int]]:
        """[begin, end) index range per chromosome (genes are contiguous per chr)."""
        ranges = []
        for c in range(self.num_chrs):
            idx = np.nonzero(self.chr_ids == c)[0]
            if idx.size == 0:
                ranges.append((0, 0))
            else:
                if not np.all(np.diff(idx) == 1):
                    raise ValueError(f"genes of chromosome {self.chr_names[c]} are not contiguous")
                ranges.append((int(idx[0]), int(idx[-1]) + 1))
        return ranges

    def chr_gene_indices(self, chr_name: str) -> np.ndarray:
        c = self.chr_names.index(chr_name)
        return np.nonzero(self.chr_ids == c)[0]

    def subset(self, keep_idx: np.ndarray) -> "GeneOrder":
        """Subset genes (order preserved). Mirrors remove_genes (inferCNV.R:445-457)."""
        keep_idx = np.asarray(keep_idx)
        if keep_idx.dtype == bool:
            keep_idx = np.nonzero(keep_idx)[0]
        names = tuple(self.names[i] for i in keep_idx)
        chr_ids = self.chr_ids[keep_idx]
        # keep chr_names stable (R keeps factor levels); empty chrs remain as levels
        return GeneOrder(
            names=names,
            chr_names=self.chr_names,
            chr_ids=chr_ids,
            start=self.start[keep_idx],
            stop=self.stop[keep_idx],
        )

    def fingerprint(self) -> Tuple:
        """Hashable identity used as a cache key for compiled layouts."""
        return (
            len(self.names),
            self.chr_names,
            hash(self.chr_ids.tobytes()),
            hash(self.start.tobytes()),
            hash(self.stop.tobytes()),
        )


def order_reduce(
    expr: np.ndarray,
    gene_names: Sequence[str],
    gene_order_table: Dict[str, Tuple[str, int, int]],
    chr_order: Sequence[str],
) -> Tuple[np.ndarray, GeneOrder, np.ndarray]:
    """Order genes of `expr` ([G, C]) genomically and drop unmatched genes.

    Mirrors ``.order_reduce`` (reference R/inferCNV.R:352-428): genes present in
    both the matrix and order table are kept; genes with start+stop == 0 are
    dropped; ordering is (chr in file order, start, stop) with a stable sort.

    Returns (expr_reordered [G', C], GeneOrder, kept_row_indices).
    """
    chr_level = {c: i for i, c in enumerate(chr_order)}
    keep: List[Tuple[int, int, int, int]] = []  # (chr_lvl, start, stop, row)
    for row, g in enumerate(gene_names):
        ent = gene_order_table.get(g)
        if ent is None:
            continue
        chrom, start, stop = ent
        if start + stop == 0:
            continue
        lvl = chr_level.get(chrom)
        if lvl is None:
            continue
        keep.append((lvl, int(start), int(stop), row))
    if not keep:
        raise ValueError("Error, no gene names match between matrix and gene order table")
    keep.sort(key=lambda t: (t[0], t[1], t[2]))
    rows = np.array([t[3] for t in keep], dtype=np.int64)
    names = tuple(gene_names[r] for r in rows)
    go = GeneOrder(
        names=names,
        chr_names=tuple(chr_order),
        chr_ids=np.array([t[0] for t in keep], np.int32),
        start=np.array([t[1] for t in keep], np.int64),
        stop=np.array([t[2] for t in keep], np.int64),
    )
    return expr[rows, :], go, rows
