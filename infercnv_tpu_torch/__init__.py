"""infercnv_tpu_torch: the PyTorch/CUDA port of infercnv_tpu for NVIDIA Hopper.

The JAX package ``infercnv_tpu`` is the reference; this package does all
that it does, in PyTorch, with each of its TPU kernels rewritten by hand in
CUDA C++ for ``sm_90a`` (sources under ``csrc/``, built with nvcc at first
use into ``build/infercnv_tpu_torch/``).  It imports neither JAX nor
``infercnv_tpu``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version instead.  The streaming engine
(:class:`infercnv_tpu_torch.parallel.engine.CnvEngine`) shards its cell
chunks over a ``CellMesh`` of one or many GPUs (``run(n_devices=...)``,
``run(mesh=...)``, several processes under ``torch.distributed``); the
Leiden is the reference's C++ (``native/``), built with g++ at first use.

The API surface is the reference's (infercnv_tpu/__init__.py:46-196): the
lazy aliases of the reference's exported names and ``CreateInfercnvObject``
in both calling conventions.  The JAX package's persistent compile cache
has no counterpart: the port builds its kernels once into ``build/``.
Importing the package builds nothing.
"""

__version__ = "0.1.0"

import os as _os

from infercnv_tpu_torch.device import resolve_device  # noqa: F401
from infercnv_tpu_torch.core.object import InferCNV, create_infercnv_object  # noqa: F401
from infercnv_tpu_torch.core.genome import GeneOrder  # noqa: F401


def run(*args, **kwargs):
    """Lazy alias for :func:`infercnv_tpu_torch.runner.pipeline.run`."""
    from infercnv_tpu_torch.runner.pipeline import run as _run

    return _run(*args, **kwargs)


def apply_median_filtering(*args, **kwargs):
    """Lazy alias for :func:`infercnv_tpu_torch.ops.median_filter.apply_median_filtering`."""
    from infercnv_tpu_torch.ops.median_filter import apply_median_filtering as _f

    return _f(*args, **kwargs)


def plot_cnv(*args, **kwargs):
    """Lazy alias for :func:`infercnv_tpu_torch.viz.heatmap.plot_cnv`."""
    from infercnv_tpu_torch.viz.heatmap import plot_cnv as _f

    return _f(*args, **kwargs)


def plot_per_group(*args, **kwargs):
    """Lazy alias for :func:`infercnv_tpu_torch.viz.per_group.plot_per_group`."""
    from infercnv_tpu_torch.viz.per_group import plot_per_group as _f

    return _f(*args, **kwargs)


def sample_object(*args, **kwargs):
    """Lazy alias for :func:`infercnv_tpu_torch.viz.per_group.sample_object`."""
    from infercnv_tpu_torch.viz.per_group import sample_object as _f

    return _f(*args, **kwargs)


def add_to_metadata(*args, **kwargs):
    """Lazy alias for :func:`infercnv_tpu_torch.report.seurat_export.add_to_metadata`
    (the add_to_seurat analogue)."""
    from infercnv_tpu_torch.report.seurat_export import add_to_metadata as _f

    return _f(*args, **kwargs)


def add_to_seurat(*args, **kwargs):
    """Lazy alias for :func:`infercnv_tpu_torch.report.seurat_export.add_to_seurat`:
    file-based metadata export from a finished out_dir (the reference's
    exported add_to_seurat, R/seurat_interaction.R:23)."""
    from infercnv_tpu_torch.report.seurat_export import add_to_seurat as _f

    return _f(*args, **kwargs)


def plot_subclusters(*args, **kwargs):
    """Lazy alias for :func:`infercnv_tpu_torch.viz.subclusters.plot_subclusters`
    (reference exported plot_subclusters, inferCNV_tumor_subclusters.R:336)."""
    from infercnv_tpu_torch.viz.subclusters import plot_subclusters as _f

    return _f(*args, **kwargs)


def inferCNVBayesNet(*args, **kwargs):
    """Lazy alias for :func:`infercnv_tpu_torch.models.bayes.inferCNVBayesNet`
    (reference exported name, inferCNV_BayesNet.R:1237)."""
    from infercnv_tpu_torch.models.bayes import inferCNVBayesNet as _f

    return _f(*args, **kwargs)


def filterHighPNormals(*args, **kwargs):
    """Lazy alias for :func:`infercnv_tpu_torch.models.bayes.filterHighPNormals`
    (reference exported name, inferCNV_BayesNet.R:1394)."""
    from infercnv_tpu_torch.models.bayes import filterHighPNormals as _f

    return _f(*args, **kwargs)


def color_palette(*args, **kwargs):
    """Lazy alias for :func:`infercnv_tpu_torch.viz.heatmap.color_palette`
    (reference exported color.palette, inferCNV_ops.R:1808)."""
    from infercnv_tpu_torch.viz.heatmap import color_palette as _f

    return _f(*args, **kwargs)


# CamelCase alias matching the reference's exported constructor name
def CreateInfercnvObject(*args, **kwargs):
    """The reference's exported constructor (R/inferCNV.R:133-337), both
    calling conventions:

    * reference style — ``CreateInfercnvObject(raw_counts_matrix=<path or
      genes x cells DataFrame>, annotations_file=<path>,
      gene_order_file=<path>, ref_group_names=[...], delim="\\t", ...)``
      (file paths may be tsv/gz/.rds/.mtx/.h5ad/10x-.h5);
    * in-memory arrays — the keyword signature of
      :func:`infercnv_tpu_torch.core.object.create_infercnv_object`.
    """
    ref_style = ("raw_counts_matrix" in kwargs or "annotations_file" in kwargs
                 or "gene_order_file" in kwargs
                 or (args and isinstance(args[0], (str, _os.PathLike))))
    if not ref_style:
        return create_infercnv_object(*args, **kwargs)
    names = ("raw_counts_matrix", "gene_order_file", "annotations_file",
             "ref_group_names")
    for name, val in zip(names, args):
        if name in kwargs:
            raise TypeError(f"CreateInfercnvObject() got multiple values for {name!r}")
        kwargs[name] = val
    counts = kwargs.pop("raw_counts_matrix")
    gene_order_file = kwargs.pop("gene_order_file")
    annotations_file = kwargs.pop("annotations_file")
    ref_group_names = kwargs.pop("ref_group_names", None)
    sep = kwargs.pop("delim", "\t")
    passthrough = {k: kwargs.pop(k) for k in
                   ("chr_exclude", "min_max_counts_per_cell",
                    "max_cells_per_group") if k in kwargs}
    if kwargs:
        raise TypeError("CreateInfercnvObject() got unexpected keyword "
                        f"argument(s): {sorted(kwargs)}")
    if isinstance(counts, (str, _os.PathLike)):
        from infercnv_tpu_torch.io.loaders import load_infercnv_object

        return load_infercnv_object(
            counts_path=_os.fspath(counts), gene_order_path=_os.fspath(gene_order_file),
            annotations_path=_os.fspath(annotations_file),
            ref_group_names=ref_group_names, sep=sep, **passthrough)
    # genes x cells DataFrame (the reference's in-memory matrix form carries
    # dimnames; the Python analogue is a pandas-like frame)
    if not (hasattr(counts, "index") and hasattr(counts, "columns")):
        raise TypeError(
            "raw_counts_matrix must be a file path or a genes x cells "
            "DataFrame (rownames=genes, colnames=cells); for bare arrays "
            "use create_infercnv_object(counts_matrix=..., gene_names=..., "
            "cell_names=...)")
    from infercnv_tpu_torch.io.loaders import read_annotations_file, read_gene_order_file

    table, chr_order = read_gene_order_file(_os.fspath(gene_order_file))
    ann = read_annotations_file(_os.fspath(annotations_file))
    import numpy as _np

    return create_infercnv_object(
        counts_matrix=_np.asarray(counts, _np.float64),
        gene_names=[str(g) for g in counts.index],
        cell_names=[str(c) for c in counts.columns],
        annotations=ann, gene_order_table=table, chr_file_order=chr_order,
        ref_group_names=ref_group_names, **passthrough)
