"""``round.histogram_ms`` of the leaf-wise cell, which reports its rate as
leafwise_rounds_per_s."""

from benchmark.harness import read_metric


def read(ctx):
    return read_metric("round.histogram_ms", ctx)
