"""Host calls that put work on the card (kernel and graph launches, async
copies and sets), counted in the profiler's CPU activity, per traced round.
Layer: session and dispatch (models/booster.py _TrainingSession.run_rounds,
models/round_graph.py)."""


def read(ctx):
    if not ctx.rounds:
        return None
    return ctx.trace.launch_calls / ctx.rounds
