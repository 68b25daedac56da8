"""cells_per_s: every cell of every job completed in the window, over the
window's wall time on the host clock (first job's start to last job's end)."""


def read(ctx):
    return ctx.cells_done / ctx.window_s
