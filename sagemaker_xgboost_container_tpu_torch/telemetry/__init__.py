"""Serving telemetry: the metrics registry, ``/metrics``, structured stdout
records, request correlation, spans and the SLO window.

What the serving package imports from here::

    from ..telemetry import REGISTRY, POW2_BUCKETS   # process-wide registry
    from ..telemetry import instrument_wsgi          # request metrics + /metrics
    from ..telemetry import emit_metric, snapshot_fields  # stdout records
    from ..telemetry import get_request_id           # request correlation
    from ..telemetry import tracing, slo             # spans / SLO window
"""

from . import slo, tracing  # noqa: F401
from .correlation import get_request_id  # noqa: F401
from .emit import emit_metric, snapshot_fields  # noqa: F401
from .registry import POW2_BUCKETS, REGISTRY  # noqa: F401
from .wsgi import METRICS_ENDPOINT_ENV, instrument_wsgi, metrics_endpoint_enabled  # noqa: F401
