"""Telemetry: the metrics registry, ``/metrics``, structured stdout records,
request correlation, spans, the SLO window, and the single-host training
planes (round state and runtime gauges, the device window, model quality).

What the rest of the package imports from here::

    from ..telemetry import REGISTRY, POW2_BUCKETS   # process-wide registry
    from ..telemetry import span, PhaseRecorder      # phase timing
    from ..telemetry import emit_metric, snapshot_fields  # stdout records
    from ..telemetry import instrument_wsgi          # request metrics + /metrics
    from ..telemetry import register_runtime_gauges  # RSS / fds / threads / device bytes
    from ..telemetry import get_request_id           # serving request correlation
    from ..telemetry import tracing, slo, device, model  # spans / SLO / planes

The fleet plane (``/status``, span shipping) is not ported yet (ROADMAP
Queue 1 item 5b), nor the heartbeats (item 9).
"""

from . import device, model, slo, tracing  # noqa: F401
from .cluster import (  # noqa: F401
    ROUND_STATE,
    compile_stats,
    refresh_runtime_gauges,
    register_runtime_gauges,
    runtime_snapshot,
)
from .correlation import get_request_id  # noqa: F401
from .emit import (  # noqa: F401
    STRUCTURED_METRICS_ENV,
    emit_metric,
    get_round_fields,
    set_round_fields,
    snapshot_fields,
    structured_enabled,
)
from .registry import POW2_BUCKETS, REGISTRY, percentile  # noqa: F401
from .spans import (  # noqa: F401
    PhaseRecorder,
    active_recorder,
    pop_recorder,
    push_recorder,
    span,
)
from .wsgi import METRICS_ENDPOINT_ENV, instrument_wsgi, metrics_endpoint_enabled  # noqa: F401
