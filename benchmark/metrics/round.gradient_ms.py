"""Device ms a round of the ``gradient`` stage: the objective's gradients and hessians
(LambdaMART's pair pass included), stamped on the card inside the captured round
(ops/stamps.py, csrc/stamp_kernel.cu) and read from the tracer's ``round.gradient``
spans of the traced window's rounds. Layer: tree build, objective and ranking ops."""

from benchmark.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "gradient")
