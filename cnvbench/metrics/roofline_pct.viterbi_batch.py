"""roofline_pct.viterbi_batch: kernel 2's throughput regime
(ops/viterbi_kernel.py), the per-cell Viterbi of every cell of a job."""

from cnvbench import roofline
from cnvbench.metrics import roofline_share


def read(ctx):
    return roofline_share(ctx, "viterbi_batch_kernel", lambda c: roofline.viterbi(
        c.cells_per_job, c.genes, c.hmm_states))
