"""File ingestion: counts matrices, gene-order files, annotation files.

Copied from infercnv_tpu/io/loaders.py (numpy, with h5py and scipy imported
inside the readers that need them; ``.rds`` counts and the reference's
``.rda`` example through the port's copy of the R serialisation reader,
io/rds.py).

Analogue of the input-parsing half of ``CreateInfercnvObject``
(reference R/inferCNV.R:146-198): tab-separated counts (optionally gzipped),
a 4-column gene order file (gene, chr, start, stop), and a 2-column
cell-annotation file.  Also supports 10x-style MTX triplets, AnnData
``.h5ad`` and CellRanger ``.h5``.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from infercnv_tpu_torch.core.object import InferCNV, create_infercnv_object
from infercnv_tpu_torch.utils.logging import log_info


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_counts_matrix(path: str, sep: str = "\t") -> Tuple[np.ndarray, List[str], List[str]]:
    """Read a genes x cells counts table. Returns (matrix [G, C], gene_names, cell_names).

    Accepts tab/comma-separated text (optionally gzipped), ``.rds``,
    ``.h5ad`` and ``.h5``."""
    log_info(f"Reading counts matrix: {path}")
    if path.endswith(".rds") or path.endswith(".RDS"):
        return _read_counts_rds(path)
    if path.endswith(".h5ad") or path.endswith(".h5"):
        return read_h5ad_counts(path)
    def unq(s: str) -> str:
        # R's write.table quotes names by default (quote=TRUE); read.table
        # strips them natively — mirror that
        return s[1:-1] if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'" else s

    with _open(path) as f:
        header = [unq(h) for h in f.readline().rstrip("\n").split(sep)]
        # header may or may not carry a leading corner label
        first = f.readline().rstrip("\n").split(sep)
        ncols = len(first) - 1
        if len(header) == ncols:
            cell_names = header
        else:
            cell_names = header[1:]
        gene_names = [unq(first[0])]
        rows = [np.array(first[1:], np.float64)]
        for line in f:
            parts = line.rstrip("\n").split(sep)
            if len(parts) < 2:
                continue
            gene_names.append(unq(parts[0]))
            rows.append(np.array(parts[1:], np.float64))
    mat = np.vstack(rows)
    log_info(f"-counts matrix: {mat.shape[0]} genes x {mat.shape[1]} cells")
    return mat, gene_names, cell_names


def _read_counts_rds(path: str) -> Tuple[np.ndarray, List[str], List[str]]:
    """Read an .rds counts matrix (dense R matrix, data.frame, or dgCMatrix)
    (infercnv_tpu/io/loaders.py:65-85)."""
    from infercnv_tpu_torch.io.rds import (
        RObj, r_data_frame, r_dgc_matrix, r_matrix, read_rds,
    )

    obj = read_rds(path)
    if isinstance(obj, RObj) and obj.rclass and "dgCMatrix" in obj.rclass:
        sp_mat, rows, cols = r_dgc_matrix(obj)
        return np.asarray(sp_mat.toarray(), np.float64), rows, cols
    if isinstance(obj, RObj) and obj.rclass and "data.frame" in obj.rclass:
        df = r_data_frame(obj)
        rows = df.pop("__rownames__")
        cols = list(df)
        mat = np.column_stack([np.asarray(df[c], np.float64) for c in cols])
        return mat, rows, cols
    if isinstance(obj, RObj) and "dim" in obj.attrs:
        mat, rows, cols = r_matrix(obj)
        return np.asarray(mat, np.float64), rows, cols
    raise ValueError(f"unsupported .rds payload in {path}: expected matrix, "
                     "data.frame, or dgCMatrix")


def _h5_string_array(ds) -> List[str]:
    vals = ds[()]
    return [v.decode() if isinstance(v, bytes) else str(v) for v in vals]


def _h5_index(group):
    """Resolve an AnnData dataframe group's index column."""
    name = group.attrs.get("_index", "_index")
    if isinstance(name, bytes):
        name = name.decode()
    if name in group:
        return _h5_string_array(group[name])
    # categorical / older encodings
    for cand in ("index", "_index"):
        if cand in group:
            return _h5_string_array(group[cand])
    raise ValueError("could not locate index in h5ad dataframe group")


def _read_10x_h5(f) -> Tuple[np.ndarray, List[str], List[str]]:
    """CellRanger v3 HDF5: /matrix CSC (genes x cells) with features/barcodes."""
    import scipy.sparse as sp

    g = f["matrix"]
    shape = tuple(int(v) for v in g["shape"][()])  # (genes, cells)
    m = sp.csc_matrix((g["data"][()], g["indices"][()], g["indptr"][()]),
                      shape=shape)
    feats = g["features"]["name" if "name" in g["features"] else "id"]
    gene_names = _h5_string_array(feats)
    cell_names = _h5_string_array(g["barcodes"])
    return np.asarray(m.toarray(), np.float64), gene_names, cell_names


def read_h5ad_counts(path: str, layer: Optional[str] = None) -> Tuple[np.ndarray, List[str], List[str]]:
    """Read an AnnData ``.h5ad`` file's counts into a dense [G, C] matrix.

    Needs only h5py (not the anndata package): reads ``/X`` (or
    ``/layers/<layer>``) in dense, csr_matrix, or csc_matrix encodings, with
    gene names from ``/var`` and cell names from ``/obs``.  Note AnnData
    stores cells x genes; this transposes to the genes x cells orientation
    the reference uses."""
    import h5py
    import scipy.sparse as sp

    with h5py.File(path, "r") as f:
        if "matrix" in f and "X" not in f:
            return _read_10x_h5(f)
        node = f["layers"][layer] if layer else f["X"]
        if isinstance(node, h5py.Dataset):
            x_cg = np.asarray(node[()], np.float64)  # [C, G]
        else:
            enc = node.attrs.get(
                "encoding-type", node.attrs.get("h5sparse_format", b""))
            if isinstance(enc, bytes):
                enc = enc.decode()
            shape = tuple(int(v) for v in node.attrs.get(
                "shape", node.attrs.get("h5sparse_shape", (0, 0))))
            data = node["data"][()]
            indices = node["indices"][()]
            indptr = node["indptr"][()]
            if "csr" in enc or "csc" in enc:
                cls = sp.csr_matrix if "csr" in enc else sp.csc_matrix
            else:
                # no encoding attribute: infer from the indptr length
                # (csr has shape[0]+1 pointers, csc shape[1]+1)
                if len(indptr) == shape[0] + 1 and shape[0] != shape[1]:
                    cls = sp.csr_matrix
                elif len(indptr) == shape[1] + 1 and shape[0] != shape[1]:
                    cls = sp.csc_matrix
                else:
                    raise ValueError(
                        f"{path!r}: sparse X has no encoding-type/"
                        "h5sparse_format attribute and the layout cannot be "
                        "inferred (square matrix) — re-save with a current "
                        "anndata version")
            x_cg = np.asarray(cls((data, indices, indptr), shape=shape).toarray(),
                              np.float64)
        cell_names = _h5_index(f["obs"])
        gene_names = _h5_index(f["var"])
    if x_cg.shape != (len(cell_names), len(gene_names)):
        raise ValueError(
            f"h5ad X shape {x_cg.shape} does not match obs x var "
            f"({len(cell_names)}, {len(gene_names)})")
    return x_cg.T.copy(), gene_names, cell_names


def read_gene_order_file(path: str) -> Tuple[Dict[str, Tuple[str, int, int]], List[str]]:
    """Read gene-order file (gene, chr, start, stop).

    Returns (gene -> (chr, start, stop), chromosome names in file order).
    """
    table: Dict[str, Tuple[str, int, int]] = {}
    chr_order: List[str] = []
    seen = set()
    with _open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4 or parts[0] == "":
                continue
            g, chrom, start, stop = parts[0], parts[1], parts[2], parts[3]
            table[g] = (chrom, int(float(start)), int(float(stop)))
            if chrom not in seen:
                seen.add(chrom)
                chr_order.append(chrom)
    return table, chr_order


def read_annotations_file(path: str) -> Dict[str, str]:
    """Read a 2-column (cell, group) annotation file."""
    ann: Dict[str, str] = {}
    with _open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and parts[0]:
                ann[parts[0]] = parts[1]
    return ann


def read_mtx(matrix_path: str, features_path: str, barcodes_path: str) -> Tuple[np.ndarray, List[str], List[str]]:
    """Read a 10x-style MTX triplet into a dense [G, C] matrix."""
    with _open(features_path) as f:
        gene_names = []
        for l in f:
            if not l.strip():
                continue
            cols = l.rstrip("\n").split("\t")
            # CellRanger triplets are (ensembl id, SYMBOL, type): prefer the
            # symbol column like the .h5 loader, so the same dataset yields
            # the same gene identifiers in either format
            gene_names.append(cols[1].strip() if len(cols) >= 2 and cols[1].strip()
                              else cols[0].strip())
    with _open(barcodes_path) as f:
        cell_names = [l.strip() for l in f if l.strip()]
    with _open(matrix_path) as f:
        header_done = False
        mat = None
        for line in f:
            if line.startswith("%"):
                continue
            parts = line.split()
            if not parts:  # blank/trailing lines are legal in MTX files
                continue
            if not header_done:
                g, c, _nnz = int(parts[0]), int(parts[1]), int(parts[2])
                mat = np.zeros((g, c), np.float64)
                header_done = True
                continue
            i, j, v = int(parts[0]) - 1, int(parts[1]) - 1, float(parts[2])
            mat[i, j] = v
    if mat is None:
        raise ValueError(f"empty mtx file: {matrix_path}")
    return mat, gene_names, cell_names


def load_infercnv_object(
    counts_path: str,
    gene_order_path: str,
    annotations_path: str,
    ref_group_names: Sequence[str],
    chr_exclude: Sequence[str] = ("chrX", "chrY", "chrM"),
    min_max_counts_per_cell: Tuple[float, float] = (100.0, float("inf")),
    max_cells_per_group=None,
    sep: str = "\t",
) -> InferCNV:
    """One-call ingestion mirroring CreateInfercnvObject on file paths."""
    mat, gene_names, cell_names = read_counts_matrix(counts_path, sep=sep)
    table, chr_order = read_gene_order_file(gene_order_path)
    ann = read_annotations_file(annotations_path)
    return create_infercnv_object(
        counts_matrix=mat,
        gene_names=gene_names,
        cell_names=cell_names,
        annotations=ann,
        gene_order_table=table,
        chr_file_order=chr_order,
        ref_group_names=ref_group_names,
        chr_exclude=chr_exclude,
        min_max_counts_per_cell=min_max_counts_per_cell,
        max_cells_per_group=max_cells_per_group,
    )


def _rda_example_tables(base: str):
    """Parse the reference's packaged example .rda datasets
    (reference R/data.R:1-22: infercnv_data_example 8252x20,
    infercnv_annots_example, infercnv_genes_example;
    infercnv_tpu/io/loaders.py:270-296)."""
    from infercnv_tpu_torch.io.rds import r_data_frame, read_rda

    d = os.path.join(base, "data")
    ddf = r_data_frame(read_rda(os.path.join(d, "infercnv_data_example.rda"))["infercnv_data_example"])
    genes = ddf.pop("__rownames__")
    cells = list(ddf)
    mat = np.column_stack([np.asarray(ddf[c], np.float64) for c in cells])  # [G, C]
    adf = r_data_frame(read_rda(os.path.join(d, "infercnv_annots_example.rda"))["infercnv_annots_example"])
    ann_col = [c for c in adf if c != "__rownames__"][0]
    ann = dict(zip(adf["__rownames__"], [str(v) for v in adf[ann_col]]))
    gdf = r_data_frame(read_rda(os.path.join(d, "infercnv_genes_example.rda"))["infercnv_genes_example"])
    cols = [c for c in gdf if c != "__rownames__"]
    chrs = [str(c) for c in gdf[cols[0]]]
    starts = np.asarray(gdf[cols[1]])
    stops = np.asarray(gdf[cols[2]])
    table = {g: (c, int(s), int(e)) for g, c, s, e in zip(gdf["__rownames__"], chrs, starts, stops)}
    chr_order: List[str] = []
    seen = set()
    for c in chrs:
        if c not in seen:
            seen.add(c)
            chr_order.append(c)
    return mat, genes, cells, ann, table, chr_order


def load_r_golden_example(ref_group_names: Sequence[str] = ("normal",)) -> InferCNV:
    """Build an InferCNV object from the reference's packaged example data —
    the Python analogue of R's ``data(infercnv_data_example); ...;
    CreateInfercnvObject(...)`` (reference R/inferCNV_ops.R:223-230)."""
    base = os.environ.get("INFERCNV_REFERENCE_DIR", "/root/reference")
    mat, genes, cells, ann, table, chr_order = _rda_example_tables(base)
    return create_infercnv_object(
        counts_matrix=mat, gene_names=genes, cell_names=cells,
        annotations=ann, gene_order_table=table, chr_file_order=chr_order,
        ref_group_names=list(ref_group_names),
    )


def load_bundled_example() -> InferCNV:
    """Load the oligodendroglioma example bundled with the reference
    (reference example/run.R:8-25, inst/extdata/*)."""
    base = os.environ.get("INFERCNV_REFERENCE_DIR", "/root/reference")
    return load_infercnv_object(
        counts_path=os.path.join(base, "inst/extdata/oligodendroglioma_expression_downsampled.counts.matrix.gz"),
        gene_order_path=os.path.join(base, "inst/extdata/gencode_downsampled.EXAMPLE_ONLY_DONT_REUSE.txt"),
        annotations_path=os.path.join(base, "inst/extdata/oligodendroglioma_annotations_downsampled.txt"),
        ref_group_names=["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"],
    )
