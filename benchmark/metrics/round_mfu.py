"""The whole round's share of the chip's peak: the traced rounds' least
time (work.py's count of every part of the round against the roofline)
over the traced window's time."""

from benchmark.work import least_seconds


def read(ctx):
    if not ctx.work or ctx.trace.window_s <= 0:
        return None
    least = sum(least_seconds(w["bytes"], w["ops"], ctx.peaks) for w in ctx.work)
    return 100.0 * least / ctx.trace.window_s
