"""ref_stats_ms: the device time of CnvEngine.ref_stats as the program
records it (its span ``icnv.ref_stats``, CUDA events inside the call;
infercnv_tpu_torch/utils/profiling.py), summed over the traced window, over
the jobs.  None untraced, or where the program records no such span."""


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    try:
        from infercnv_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t = span_totals().get("icnv.ref_stats")
    return None if t is None else t["device_ms"] / ctx.jobs
