"""``hist_roofline`` of the leaf-wise cell, which reports its rate as
leafwise_rounds_per_s (a bound of its own: its runs spread far less than
the level-wise cell's)."""

from benchmark.harness import read_metric


def read(ctx):
    return read_metric("hist_roofline", ctx)
