"""Share of the traced window in which nothing ran on the card: 1 minus the
union of its kernel, memcpy and memset intervals over the window."""


def read(ctx):
    if ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
