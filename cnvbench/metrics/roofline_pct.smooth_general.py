"""roofline_pct.smooth_general: kernel 5 (ops/smoothing.py), the tiled
smooth of the wide-band route, over a job's reference cells (ref_stats)
and all its cells (the chunks)."""

from cnvbench import roofline
from cnvbench.metrics import roofline_share


def read(ctx):
    return roofline_share(ctx, "smooth_general_kernel", lambda c: roofline.smooth(
        c.ref_cells + c.cells_per_job, c.genes, c.band_nonzeros))
