"""host_syncs_per_job: the program's counter ``host_syncs`` (operations in
the engine's calls that make the host wait for the card: blocking uploads
of host data, reads of device values on the host;
infercnv_tpu_torch/utils/profiling.py) over the traced window, over the
jobs.  None untraced, or where the program has no such counter."""


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    try:
        from infercnv_tpu_torch.utils.profiling import HOST_SYNCS, counter_totals
    except ImportError:
        return None
    return counter_totals().get(HOST_SYNCS, 0) / ctx.jobs
