"""chunk_ms: the device span (CUDA events recorded around each call) of the
window's subcluster_chunk / full_chunk calls, summed, over their count."""


def read(ctx):
    ms = ctx.spans.ms("chunk")
    return sum(ms) / len(ms) if ms else None
