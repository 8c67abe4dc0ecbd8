"""Device ms a round of the ``histogram`` stage: the level histograms and node totals
(hist_* / totals_* kernels) with sibling subtraction, stamped on the card inside the
captured round (ops/stamps.py, csrc/stamp_kernel.cu) and read from the tracer's
``round.histogram`` spans of the traced window's rounds. Layer: kernels
(ops/histogram.py over csrc/hist_kernel.cu, csrc/totals_kernel.cu)."""

from benchmark.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "histogram")
