"""Device ms a round of the ``margins`` stage: the training and eval margins, device
metrics and the packing, stamped on the card inside the captured round
(ops/stamps.py, csrc/stamp_kernel.cu) and read from the tracer's ``round.margins``
spans of the traced window's rounds. Layer: tree build, objective and ranking ops."""

from benchmark.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "margins")
