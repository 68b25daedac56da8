"""per_job_ms: the device spans (CUDA events) of each job's calls outside
the chunk loop, ref_stats and (subclusters) viterbi_group_means, summed over
the window, over the jobs."""


def read(ctx):
    ms = ctx.spans.ms("ref_stats") + ctx.spans.ms("viterbi")
    return sum(ms) / ctx.jobs if ms and ctx.jobs else None
