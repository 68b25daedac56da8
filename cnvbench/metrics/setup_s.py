"""setup_s: process start to the first timed job, on the host clock: torch
and the CUDA context, loading (or building) the kernels, the cohort's draws,
per-sample statistics and engines, and the warm jobs."""


def read(ctx):
    return ctx.setup_s
