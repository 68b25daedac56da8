"""Plots: the heatmap (its data side on the device), the subcluster, Bayes
and MCMC plots, the per-group plots (infercnv_tpu/viz/__init__.py:1)."""
from infercnv_tpu_torch.viz.bayes_plots import gelman_rubin  # noqa: F401
from infercnv_tpu_torch.viz.heatmap import color_palette, get_x_range_auto, plot_cnv  # noqa: F401
