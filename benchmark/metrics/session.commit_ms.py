"""Host ms a round of the session's commit (``session.commit``: the
compaction of the round's trees, ``Forest.append_round`` and the learning
record), from its profiler ranges inside the traced window. Layer: session
and dispatch (models/booster.py)."""

from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx, "session.commit")
