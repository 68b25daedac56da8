"""Readers of the benchmark's metrics, one file each, named as the metric
in BENCHMARK.json: ``read(ctx)`` returns the value, or None where the run
holds nothing to read (the harness then leaves the metric out)."""

from cnvbench import roofline


def roofline_share(ctx, kernel: str, work) -> float:
    """100 x the least time of the traced window's work for ``kernel`` (a
    __global__ function's name) over the device time of its launches there;
    ``work(ctx)`` gives a job's (bytes, operations).  Records the bound and
    both times in ctx.notes."""
    if ctx.trace is None or not ctx.jobs:
        return None
    device_s = ctx.trace.kernel_seconds().get(kernel, 0.0)
    if device_s <= 0:
        return None
    nbytes, flops = work(ctx)
    least_s, by = roofline.least_seconds(nbytes * ctx.jobs, flops * ctx.jobs)
    ctx.notes[kernel] = {"bound_by": by, "least_ms_a_job": 1e3 * least_s / ctx.jobs,
                         "device_ms_a_job": 1e3 * device_s / ctx.jobs}
    return 100.0 * least_s / device_s
