"""job_p95_ms: the 95th percentile (linear between order statistics) of the
wall time of all the window's jobs, from the call that starts a job's
ref_stats to its states (and group sums) on the host."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.job_seconds) * 1e3, 95))
