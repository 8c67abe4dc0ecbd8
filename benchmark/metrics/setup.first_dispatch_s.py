"""Host seconds from the train() call to the first dispatch boundary, less
the binning: the session's upload, query-group layout, first eager round
and the capture of the round graph. Layer: session start (models/booster.py,
models/round_graph.py)."""


def read(ctx):
    return ctx.spans.get("first_dispatch_s")
