"""The histogram kernels' share of their roofline: the least time the traced
rounds' histograms and node totals need on the chip (work.py: the larger of
bytes over HBM bandwidth and adds over the float32 peak, call by call)
over the device time of every hist_* and totals_* kernel in the window.
Layer: kernels (ops/histogram.py over csrc/hist_kernel.cu, csrc/totals_kernel.cu)."""

from benchmark.work import least_seconds


def read(ctx):
    device = ctx.trace.hist_seconds()
    if device <= 0 or not ctx.work:
        return None
    least = sum(least_seconds(b, a, ctx.peaks) for w in ctx.work for b, a in w["hist_calls"])
    return 100.0 * least / device
