"""Per-host sharded ingestion for runs over several processes.

Copied from infercnv_tpu/io/sharded.py (``host_cell_slice`` and
``load_counts_shard`` with its .npy, .h5ad and 10x .h5 readers, lines
34-159): each process materialises only its contiguous, balanced slice of
the cells.  ``host_id``/``n_hosts`` default to the torch.distributed rank
and world size where the reference reads jax.process_index()/count(), and
``global_cell_array`` places this process's rows on its shards of a
``CellMesh`` (parallel/stats.py) where the reference assembles a global
jax.Array (:162-188).  h5py is imported only to read .h5ad / .h5 files.

Supported formats for partial reads:
* ``.h5ad`` — dense ``/X`` row-slice, or CSR row-slice via indptr (both are
  O(shard) I/O); CSC streams column blocks keeping only the shard's rows.
* 10x CellRanger ``.h5`` — CSC with cells as columns: column slices are
  contiguous in ``data``/``indices``.
* ``.npy`` — memory-mapped row slice of a [cells, genes] array.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from infercnv_tpu_torch.parallel.stats import CellMesh, CellSharded
from infercnv_tpu_torch.utils.logging import log_info


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def host_cell_slice(num_cells: int, host_id: int, n_hosts: int) -> Tuple[int, int]:
    """Balanced contiguous [lo, hi) cell range for one host: the first
    ``num_cells % n_hosts`` hosts take one extra cell."""
    if not (0 <= host_id < n_hosts):
        raise ValueError(f"host_id {host_id} outside [0, {n_hosts})")
    base, extra = divmod(num_cells, n_hosts)
    lo = host_id * base + min(host_id, extra)
    return lo, lo + base + (1 if host_id < extra else 0)


def _h5ad_shard(path: str, lo: int, hi: int, layer: Optional[str]):
    import h5py
    import scipy.sparse as sp

    with h5py.File(path, "r") as f:
        if "matrix" in f and "X" not in f:
            # 10x CellRanger: CSC [genes x cells] -> cells are columns
            g = f["matrix"]
            indptr = g["indptr"][lo:hi + 1]
            s0, s1 = int(indptr[0]), int(indptr[-1])
            data = g["data"][s0:s1]
            indices = g["indices"][s0:s1]
            n_genes = int(g["shape"][0])
            mat = sp.csc_matrix((data, indices, indptr - s0),
                                shape=(n_genes, hi - lo))
            counts = np.asarray(mat.toarray().T, np.float32)      # [shard, G]
            from infercnv_tpu_torch.io.loaders import _h5_string_array

            feats = g["features"]["name" if "name" in g["features"] else "id"]
            gene_names = _h5_string_array(feats)
            cells = _h5_string_array(g["barcodes"])[lo:hi]
            return counts, gene_names, cells
        from infercnv_tpu_torch.io.loaders import _h5_index

        node = f["layers"][layer] if layer else f["X"]
        cell_names = _h5_index(f["obs"])[lo:hi]
        gene_names = _h5_index(f["var"])
        if isinstance(node, h5py.Dataset):  # dense [C, G]: direct row slice
            counts = np.asarray(node[lo:hi], np.float32)
            return counts, gene_names, cell_names
        enc = node.attrs.get("encoding-type", b"")
        if isinstance(enc, bytes):
            enc = enc.decode()
        shape = tuple(int(v) for v in node.attrs["shape"])
        if "csr" in enc:  # rows = cells: row-slice via indptr, O(shard) I/O
            indptr = node["indptr"][lo:hi + 1]
            s0, s1 = int(indptr[0]), int(indptr[-1])
            data = node["data"][s0:s1]
            indices = node["indices"][s0:s1]
            mat = sp.csr_matrix((data, indices, indptr - s0),
                                shape=(hi - lo, shape[1]))
            return np.asarray(mat.toarray(), np.float32), gene_names, cell_names
        # csc cells-x-genes: no contiguous ROW slice exists, so stream the
        # columns in blocks and keep only rows [lo, hi) — I/O still touches
        # every column's payload (CSC is the wrong layout for row shards)
        # but host MEMORY stays O(shard + block), never the full matrix
        indptr = node["indptr"][()]
        n_genes = shape[1]
        out = np.zeros((hi - lo, n_genes), np.float32)
        BLK = 256  # columns per read
        for j0 in range(0, n_genes, BLK):
            j1 = min(j0 + BLK, n_genes)
            s0, s1 = int(indptr[j0]), int(indptr[j1])
            if s0 == s1:
                continue
            data = node["data"][s0:s1]
            rows_blk = node["indices"][s0:s1]
            sub = sp.csc_matrix((data, rows_blk, indptr[j0:j1 + 1] - s0),
                                shape=(shape[0], j1 - j0))
            out[:, j0:j1] = sub[lo:hi].toarray()
        return out, gene_names, cell_names


def load_counts_shard(
    path: str,
    host_id: Optional[int] = None,
    n_hosts: Optional[int] = None,
    layer: Optional[str] = None,
) -> Tuple[np.ndarray, List[str], List[str], Tuple[int, int]]:
    """Load THIS host's cell slice of a counts file.

    Returns (counts [shard_cells, genes] float32, gene_names,
    shard_cell_names, (lo, hi)).  host_id/n_hosts default to the rank and
    world size of the initialised torch.distributed default group, else to
    0 and 1.
    """
    if host_id is None:
        host_id = dist.get_rank() if _distributed() else 0
    if n_hosts is None:
        n_hosts = dist.get_world_size() if _distributed() else 1

    if path.endswith(".npy"):
        mm = np.load(path, mmap_mode="r")           # [cells, genes]
        lo, hi = host_cell_slice(mm.shape[0], host_id, n_hosts)
        counts = np.asarray(mm[lo:hi], np.float32)
        gene_names = [f"g{i}" for i in range(mm.shape[1])]
        cells = [f"cell_{i}" for i in range(lo, hi)]
    elif path.endswith((".h5ad", ".h5")):
        import h5py

        with h5py.File(path, "r") as f:
            if "matrix" in f and "X" not in f:
                if layer:
                    raise ValueError(
                        f"{path!r} is a 10x CellRanger .h5 (no /layers); "
                        f"layer={layer!r} cannot be honored")
                num_cells = int(f["matrix"]["shape"][1])
            else:
                # probe the SAME node _h5ad_shard will read, so the slice
                # bounds always match the matrix actually loaded
                if layer:
                    if "layers" not in f or layer not in f["layers"]:
                        raise KeyError(
                            f"{path!r}: requested layer {layer!r} not found "
                            f"in /layers")
                    node = f["layers"][layer]
                elif "X" in f:
                    node = f["X"]
                else:
                    raise KeyError(
                        f"{path!r}: no /X matrix and no layer requested; "
                        "pass layer= to select one of /layers")
                if isinstance(node, h5py.Dataset):
                    num_cells = int(node.shape[0])
                else:
                    num_cells = int(node.attrs["shape"][0])
        lo, hi = host_cell_slice(num_cells, host_id, n_hosts)
        counts, gene_names, cells = _h5ad_shard(path, lo, hi, layer)
    else:
        raise ValueError(
            f"sharded loading supports .npy/.h5ad/.h5, got {path!r} "
            "(tsv at pod scale would serialize the whole file per host)")
    log_info(f"host {host_id}/{n_hosts}: loaded cell shard [{lo}, {hi}) "
             f"({counts.shape[0]} x {counts.shape[1]})")
    return counts, gene_names, cells, (lo, hi)


def global_cell_array(local_shard: np.ndarray, mesh: CellMesh,
                      num_cells_global: int) -> CellSharded:
    """This process's [local_cells, ...] rows as its shards of the global
    cell-sharded [num_cells_global, ...] array on ``mesh``: the local rows
    must be exactly this process's share (num_cells_global / the mesh's
    process count, as load_counts_shard slices them when the division is
    even), split equally over its devices.  No process materialises the
    global array."""
    import torch

    local = torch.from_numpy(np.ascontiguousarray(local_shard))
    n = mesh.n_shards
    if num_cells_global % n:
        raise ValueError(f"{num_cells_global} cells do not split into {n} "
                         "equal shards")
    rows = num_cells_global // n
    if local.shape[0] != rows * len(mesh.devices):
        raise ValueError(f"this process holds {local.shape[0]} rows; its "
                         f"{len(mesh.devices)} shards take {rows} each")
    return CellSharded([local[i * rows:(i + 1) * rows].to(d)
                        for i, d in enumerate(mesh.devices)], mesh)
