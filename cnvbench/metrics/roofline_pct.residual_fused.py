"""roofline_pct.residual_fused: kernel 1 (ops/residual_fused.py), run once a
chunk on the fused route: u16 counts in, the residual and the denoised
residual out, over every cell of a job."""

from cnvbench import roofline
from cnvbench.metrics import roofline_share


def read(ctx):
    return roofline_share(ctx, "residual_fused_kernel", lambda c: roofline.residual_fused(
        c.cells_per_job, c.genes, c.band_nonzeros))
