"""Subcluster inspection plot.

reference: plot_subclusters (R/inferCNV_tumor_subclusters.R:336-361):
re-annotate the object with one group per subcluster and render the
standard heatmap so subcluster boundaries are visible.

Copied from infercnv_tpu/viz/subclusters.py (``plot_subclusters`` :18),
onto the port's plot_cnv (its data side on ``device``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.viz.heatmap import plot_cnv


def plot_subclusters(obj: InferCNV, out_dir: str,
                     output_filename: str = "subcluster_as_annotations",
                     **plot_kwargs):
    """plot_kwargs pass through to plot_cnv (png_res, output_format,
    hclust_method, max_pane_rows, device, ...) so the inspection plot
    matches the run's other heatmaps."""
    if obj.tumor_subclusters is None:
        return None
    ref_names = set(obj.ref_groups)
    new_ref: Dict[str, np.ndarray] = {}
    new_obs: Dict[str, np.ndarray] = {}
    for grp, subs in obj.tumor_subclusters["subclusters"].items():
        target = new_ref if grp in ref_names else new_obs
        for name, idx in subs.items():
            target[name] = np.asarray(idx)
    sub_obj = InferCNV(
        expr=obj.expr, counts=obj.counts, gene_order=obj.gene_order,
        cell_names=list(obj.cell_names),
        ref_groups=new_ref, obs_groups=new_obs,
    )
    return plot_cnv(sub_obj, out_dir=out_dir, output_filename=output_filename,
                    title="subclusters", cluster_by_groups=True,
                    **plot_kwargs)
