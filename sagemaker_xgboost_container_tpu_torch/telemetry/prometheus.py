"""Prometheus text exposition (format version 0.0.4) over a MetricsRegistry.

Rendered on demand by ``GET /metrics`` (``wsgi.py``): ``# HELP`` / ``# TYPE``
headers, one ``name{labels} value`` line per series, histograms expanded to
cumulative ``_bucket{le=...}`` series plus ``_sum`` / ``_count``. The text is
byte for byte the JAX package's for the same registry content.
"""

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(text):
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value):
    return str(value).replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _format_value(value):
    if value != value:  # NaN
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _label_str(labels, extra=None):
    items = dict(labels or {})
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, _escape_label_value(v)) for k, v in sorted(items.items()))
    return "{" + inner + "}"


def exposition_response(registry, refresh=None):
    """-> ``(status, headers, body_bytes)`` of a ``GET /metrics`` response.
    ``refresh(registry)``, when given, runs first, so sampled gauges (RSS,
    device bytes) are current at scrape time."""
    if refresh is not None:
        refresh(registry)
    body = render_text(registry).encode("utf-8")
    return (
        "200 OK",
        [("Content-Type", CONTENT_TYPE), ("Content-Length", str(len(body)))],
        body,
    )


def render_text(registry):
    """Render every family in ``registry`` to the exposition text."""
    lines = []
    for name, kind, help_text, series in registry.collect():
        if help_text:
            lines.append("# HELP {} {}".format(name, _escape_help(help_text)))
        lines.append("# TYPE {} {}".format(name, kind))
        for metric in series:
            if kind == "histogram":
                cumulative, total_sum, total_count = metric.snapshot()
                bounds = list(metric.bounds) + [float("inf")]
                for bound, cum in zip(bounds, cumulative):
                    lines.append("{}_bucket{} {}".format(
                        name, _label_str(metric.labels, {"le": _format_value(bound)}), cum))
                lines.append("{}_sum{} {}".format(
                    name, _label_str(metric.labels), _format_value(total_sum)))
                lines.append("{}_count{} {}".format(
                    name, _label_str(metric.labels), total_count))
            else:
                lines.append("{}{} {}".format(
                    name, _label_str(metric.labels), _format_value(metric.value)))
    return "\n".join(lines) + "\n"
