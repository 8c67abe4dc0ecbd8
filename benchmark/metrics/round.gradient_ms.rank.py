"""``round.gradient_ms`` of the ranking cell, which reports its rate as
rank_rounds_per_s."""

from benchmark.harness import read_metric


def read(ctx):
    return read_metric("round.gradient_ms", ctx)
