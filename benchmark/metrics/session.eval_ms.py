"""Host ms a round of the session's host evaluation (``session.eval``: the
eval metrics the device cannot batch, ndcg@10 over the validation queries
once a dispatch), from its profiler ranges inside the traced window, over
the window's rounds. Layer: session and dispatch (models/booster.py)."""

from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx, "session.eval")
