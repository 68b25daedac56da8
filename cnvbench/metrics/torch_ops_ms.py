"""torch_ops_ms: device time of every kernel that is not one of the
program's own (the __global__ functions of infercnv_tpu_torch/csrc), from
torch.profiler, per chunk: the PyTorch operations of the engine's routes,
its group-sum matmul and the Viterbi's packing."""


def read(ctx):
    if ctx.trace is None:
        return None
    n = ctx.jobs * ctx.chunks_per_job
    secs = [v for k, v in ctx.trace.kernel_seconds().items() if k not in ctx.library]
    return 1e3 * sum(secs) / n if secs and n else None
