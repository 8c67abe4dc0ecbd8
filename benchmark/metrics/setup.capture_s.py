"""Host seconds of the session's first capture of its round as a CUDA graph
and its instantiation (``round.capture``, the registry's
training_phase_seconds). Layer: session start (models/round_graph.py)."""

from benchmark.spans import phase_s


def read(ctx):
    return phase_s("round.capture")
