"""roofline_pct.row_median: kernel 7 (ops/median.py), the exact row median
that centres each smoothed cell, over a job's reference cells (ref_stats)
and all its cells (the chunks)."""

from cnvbench import roofline
from cnvbench.metrics import roofline_share


def read(ctx):
    return roofline_share(ctx, "median_rows_kernel", lambda c: roofline.row_median(
        c.ref_cells + c.cells_per_job, c.genes))
