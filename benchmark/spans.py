"""What the program records about itself, read for the per-layer metrics:
the tracer's device spans of each round's stages, the profiler's host
events of the session's leaf spans, and the registry's phase sums.

A program that records none of these (a checkout older than its stage
stamps and session spans) reads None here: the metric is left out of the
result line, and nothing raises.
"""


def _port_tracing():
    from sagemaker_xgboost_container_tpu_torch.telemetry import tracing

    return tracing


def stage_ms(ctx, stage, spans=None):
    """ms a round of the stage ``stage`` (``gradient``, ``histogram``,
    ``split``, ``partition``, ``margins``) over the traced window's rounds:
    the tracer's ``round.<stage>`` device spans of the last ``ctx.rounds``
    rounds it recorded (training stops at the window's close), or None."""
    if spans is None:
        spans = _port_tracing().snapshot_spans()
    name, by_round = "round." + stage, {}
    for s in spans:
        if s.name == name and s.attributes.get("clock") == "device":
            r = s.attributes.get("round")
            by_round[r] = by_round.get(r, 0.0) + s.dur_us
    rounds = sorted(by_round)[-ctx.rounds:] if ctx.rounds else []
    if not rounds:
        return None
    return sum(by_round[r] for r in rounds) / 1e3 / len(rounds)


def host_ms(ctx, name):
    """ms a round of the host events named ``name`` that start inside the
    profiler's window, over the window's rounds, or None where none did."""
    spans = [t1 - t0 for t0, t1, n in ctx.trace._host if n == name]
    if not spans or not ctx.rounds:
        return None
    return sum(spans) / 1e6 / ctx.rounds


def phase_s(phase, registry=None):
    """Seconds the program's ``span(phase)`` calls took in all (the
    registry's ``training_phase_seconds`` sum), or None where it never ran."""
    if registry is None:
        from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY as registry
    for name, _kind, _help, series in registry.collect():
        if name != "training_phase_seconds":
            continue
        for metric in series:
            if metric.labels.get("phase") == phase and metric.count:
                return metric.sum
    return None
