"""Telemetry: the metrics registry, ``/metrics``, structured stdout records,
request correlation, spans, the SLO window, the training planes (round
state and runtime gauges, the device window, model quality), the
multi-host heartbeats and the fleet plane.

What the rest of the package imports from here::

    from ..telemetry import REGISTRY, POW2_BUCKETS   # process-wide registry
    from ..telemetry import span, PhaseRecorder      # phase timing
    from ..telemetry import emit_metric, snapshot_fields  # stdout records
    from ..telemetry import instrument_wsgi          # request metrics + /metrics
    from ..telemetry import register_runtime_gauges  # RSS / fds / threads / device bytes
    from ..telemetry import get_request_id           # serving request correlation
    from ..telemetry import tracing, slo, device, model  # spans / SLO / planes
    from ..telemetry import start_cluster_telemetry  # heartbeats + rank-0 aggregation
    from ..telemetry import start_fleet_plane        # span shipping + /status
"""

from . import device, fleet, model, slo, tracing  # noqa: F401
from .cluster import (  # noqa: F401
    CLUSTER_METRICS_ENV,
    HEARTBEAT_INTERVAL_ENV,
    ROUND_STATE,
    compile_stats,
    refresh_runtime_gauges,
    register_runtime_gauges,
    runtime_snapshot,
    start_cluster_telemetry,
    stop_cluster_telemetry,
)
from .correlation import get_request_id  # noqa: F401
from .fleet import (  # noqa: F401
    FLEET_TRACE_ENV,
    STATUS_PORT_ENV,
    install_sigquit_handler,
    start_fleet_plane,
    stop_fleet_plane,
)
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
