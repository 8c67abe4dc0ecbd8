"""``hist_roofline`` of the ranking cell, which reports its rate as
rank_rounds_per_s (a bound of its own: its host-side ndcg evaluation once a
dispatch makes its runs spread wider than the other cells')."""

from benchmark.harness import read_metric


def read(ctx):
    return read_metric("hist_roofline", ctx)
