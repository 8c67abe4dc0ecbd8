"""Structured single-line JSON metric records on stdout.

SageMaker's CloudWatch metric definitions scrape the container's stdout with
regexes. One record per line, compact JSON, ``"metric"`` first and the
other keys sorted, so a regex like ``"round_ms": ([0-9.]+)`` is stable.
Records never contain tabs, keeping them apart from the HPO eval lines
(``[<iter>]\\t<data>-<metric>:<value>``).

``SM_STRUCTURED_METRICS=false`` silences every record (default on).
"""

import json
import sys
import threading

from ..utils.envconfig import env_bool

STRUCTURED_METRICS_ENV = "SM_STRUCTURED_METRICS"

_write_lock = threading.Lock()

# extra fields merged into every ``training.round`` record
# (``training/profiling.RoundTimer``), set by a training session for facts
# only it knows; process-wide, last writer wins, as sessions run one after
# another
_round_fields = {}
_round_fields_lock = threading.Lock()


def set_round_fields(**fields):
    """Merge fields into the per-round record; a value of None removes the
    key."""
    with _round_fields_lock:
        for key, value in fields.items():
            if value is None:
                _round_fields.pop(key, None)
            else:
                _round_fields[key] = value


def get_round_fields():
    """A copy of the extra per-round fields."""
    with _round_fields_lock:
        return dict(_round_fields)


def structured_enabled():
    return env_bool(STRUCTURED_METRICS_ENV, True)


def _jsonable(value):
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return str(value)


def emit_metric(metric, **fields):
    """Write one structured record; no-op when disabled. Returns the line
    (or None)."""
    if not structured_enabled():
        return None
    record = {"metric": metric}
    for key in sorted(fields):
        record[key] = _jsonable(fields[key])
    line = json.dumps(record, separators=(", ", ": "))
    with _write_lock:
        sys.stdout.write(line + "\n")
        sys.stdout.flush()
    return line


def snapshot_fields(registry):
    """Flatten a registry into the scalar fields of one snapshot record:
    counters and gauges as ``name{k=v,...}`` keys, histograms as ``_count``,
    ``_sum`` and p50 / p95 estimates (the ``serving.snapshot`` record of
    ``SM_METRICS_EMIT_INTERVAL_S``)."""
    fields = {}
    for name, kind, _help, series in registry.collect():
        for metric in series:
            suffix = (
                "{" + ",".join(
                    "{}={}".format(k, v) for k, v in sorted(metric.labels.items())) + "}"
                if metric.labels else ""
            )
            key = name + suffix
            if kind == "histogram":
                fields[key + "_count"] = metric.count
                fields[key + "_sum"] = round(metric.sum, 6)
                if metric.count:
                    fields[key + "_p50"] = round(metric.quantile(0.5), 6)
                    fields[key + "_p95"] = round(metric.quantile(0.95), 6)
            else:
                fields[key] = metric.value
    return fields
