"""Device milliseconds a round of every kernel that is not a hist_* or
totals_* kernel: the tree build's, split scan's, routing's, objective's,
ranking pair pass's and eval update's torch ops. Layer: ops/tree_build.py,
ops/split.py, ops/lossguide.py, ops/ranking.py, models/objectives.py,
models/booster.py's margin and eval updates."""


def read(ctx):
    if not ctx.rounds or not ctx.trace.kernel_s:
        return None
    return 1000.0 * ctx.trace.other_seconds() / ctx.rounds
