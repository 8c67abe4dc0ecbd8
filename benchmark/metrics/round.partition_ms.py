"""Device ms a round of the ``partition`` stage: routing, node-of-row updates and
lossguide's row-wide index ops, stamped on the card inside the captured round
(ops/stamps.py, csrc/stamp_kernel.cu) and read from the tracer's ``round.partition``
spans of the traced window's rounds. Layer: tree build, objective and ranking ops."""

from benchmark.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "partition")
