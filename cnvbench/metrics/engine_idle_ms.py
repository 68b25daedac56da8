"""engine_idle_ms: the device's idle time in the traced window that the
engine's own host work causes, over the jobs.  An idle gap (between the
window's merged busy intervals, as device_idle_pct counts them) is the
engine's when its middle lies inside the host range of a root engine span
(``icnv.ref_stats``, ``icnv.chunk``, ``icnv.viterbi_group_means``, from the
profiler's host events); the rest is the caller's.  None untraced, or where
the program records no such span."""

import bisect

ROOTS = ("icnv.ref_stats", "icnv.chunk", "icnv.viterbi_group_means")


def _merged(ranges):
    out = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    ranges = _merged((s, e) for name, s, e in ctx.trace.host if name in ROOTS)
    if not ranges:
        return None
    starts = [s for s, _e in ranges]
    t0, t1 = ctx.trace.window
    edges = [t0] + [x for iv in ctx.trace.busy_intervals() for x in iv] + [t1]
    idle_ns = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and ranges[i][1] >= mid:
            idle_ns += b - a
    return idle_ns * 1e-6 / ctx.jobs
