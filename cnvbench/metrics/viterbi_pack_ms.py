"""viterbi_pack_ms: the device time of the packed Viterbi's packing and
unpacking (the program's spans ``icnv.viterbi.pack`` and
``icnv.viterbi.unpack`` in ops/viterbi_pack.py: layout uploads, the gather
of the residual into bins, the repeats, the inverse gather), summed over
the traced window, over the jobs.  None untraced, or where the program
records neither span."""

NAMES = ("icnv.viterbi.pack", "icnv.viterbi.unpack")


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    try:
        from infercnv_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals()
    found = [totals[n]["device_ms"] for n in NAMES if n in totals]
    return sum(found) / ctx.jobs if found else None
