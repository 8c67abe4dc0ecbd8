"""WSGI instrumentation middleware and the ``GET /metrics`` route.

Wraps both serving apps (single-model ``make_app`` and the MME), recording
per normalized route:

* ``serving_requests_total{route, code}``, the code as its class (``2xx``,
  ``4xx``, ...);
* ``serving_request_seconds{route}``, end-to-end latency;
* ``serving_request_bytes{route}``, request payload size.

Routes fall into a closed set (``/ping``, ``/invocations``,
``/execution-parameters``, ``/metrics``, ``/models``, ``other``): raw paths
(model names, typos, scanners) never become label values.

``/metrics`` is off unless ``SM_SERVING_METRICS=true``: SageMaker endpoints
expose ``/ping`` and ``/invocations`` only, and an introspection route on a
public endpoint would leak operational detail.
"""

import time

from ..utils.envconfig import env_bool
from . import slo, tracing
from .correlation import REQUEST_ID_HEADER, clear_request_id, extract_request_id, set_request_id
from .prometheus import exposition_response
from .registry import REGISTRY

METRICS_ENDPOINT_ENV = "SM_SERVING_METRICS"

# the serving lifecycle's in-flight latch registers itself here, so that the
# telemetry package never imports the serving one. A request is finished
# only once its response body has been written (the WSGI server calls the
# result's close() after the write loop): a drain must wait for exactly
# that, or an exit right after the app returned truncates the response
_request_tracker = None


def set_request_tracker(tracker):
    """Install or clear (None) the in-flight tracker, an object with
    ``request_started()``, ``request_finished()`` and ``accepting``."""
    global _request_tracker
    _request_tracker = tracker


class _TrackedBody:
    """A WSGI result whose close() fires ``on_close`` exactly once, after
    the server wrote (or abandoned) the whole body."""

    def __init__(self, result, on_close):
        self._result = result
        self._on_close = on_close

    def __iter__(self):
        return iter(self._result)

    def close(self):
        try:
            close = getattr(self._result, "close", None)
            if close is not None:
                close()
        finally:
            self._on_close()


_KNOWN_ROUTES = ("/ping", "/invocations", "/execution-parameters", "/metrics")

# 1KB .. 8MB payload buckets (MAX_CONTENT_LENGTH defaults to 6MB)
_BYTE_BUCKETS = tuple(float(2 ** i) for i in range(10, 24))


def metrics_endpoint_enabled():
    return env_bool(METRICS_ENDPOINT_ENV, False)


def _route_label(path):
    if path in _KNOWN_ROUTES:
        return path
    if path.startswith("/models"):
        return "/models"
    return "other"


def _code_class(code):
    try:
        return "{}xx".format(int(code) // 100)
    except (TypeError, ValueError):
        return "5xx"


def instrument_wsgi(app, registry=None):
    """Wrap ``app`` with the request metrics and the /metrics route."""
    reg = registry or REGISTRY
    # armed once here when SM_SLO_P95_MS is set; a request then costs one
    # is-None test when it is not
    slo_window = slo.maybe_install(reg)

    # each (route, code) handle is resolved once: the label space is closed,
    # so the cache is bounded, and a request costs a dict hit instead of the
    # registry's lock. A racing double insert yields the same metric.
    handles = {}

    def _counter(route, code_class):
        key = ("c", route, code_class)
        metric = handles.get(key)
        if metric is None:
            metric = handles[key] = reg.counter(
                "serving_requests_total", help="Requests by route and status class",
                labels={"route": route, "code": code_class})
        return metric

    def _latency(route):
        key = ("l", route)
        metric = handles.get(key)
        if metric is None:
            metric = handles[key] = reg.histogram(
                "serving_request_seconds", help="End-to-end request latency",
                labels={"route": route})
        return metric

    def _payload(route):
        key = ("b", route)
        metric = handles.get(key)
        if metric is None:
            metric = handles[key] = reg.histogram(
                "serving_request_bytes", help="Request payload size", labels={"route": route},
                buckets=_BYTE_BUCKETS)
        return metric

    def wrapped(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        method = environ.get("REQUEST_METHOD", "GET")
        route = _route_label(path)

        # in-flight latch: started here, finished when the body is written or
        # the app raised. Requests arriving once the tracker stopped accepting
        # (draining) are not latched: they only get the fast 503, and
        # counting them would let load-balancer retries hold the drain open
        # past its deadline
        tracker = _request_tracker
        if tracker is not None and not getattr(tracker, "accepting", True):
            tracker = None
        finished = []

        def _finish():
            if tracker is not None and not finished:
                finished.append(True)
                tracker.request_finished()

        if tracker is not None:
            tracker.request_started()

        if path == "/metrics" and method == "GET":
            if not metrics_endpoint_enabled():
                # indistinguishable from any other unknown route when gated
                body = b"not found"
                start_response("404 Not Found", [("Content-Type", "text/plain"),
                                                 ("Content-Length", str(len(body)))])
                return _TrackedBody([body], _finish)
            try:
                from .cluster import refresh_runtime_gauges

                status, resp_headers, body = exposition_response(reg, refresh_runtime_gauges)
                start_response(status, resp_headers)
                _counter(route, "2xx").inc()
            except Exception:
                _finish()
                raise
            return _TrackedBody([body], _finish)

        captured = {}
        request_id = extract_request_id(environ)
        set_request_id(request_id)
        # with tracing on, the request is a trace whose id is the
        # correlation id, so the dump joins on the X-Request-Id the client saw
        tspan = None
        if tracing.enabled():
            tspan = tracing.start_span("http.request", trace_id=request_id, root=True,
                                       attributes={"route": route, "method": method})

        def recording_start_response(status, headers, exc_info=None):
            captured["status"] = status
            headers = [(k, v) for k, v in headers
                       if k.lower() != REQUEST_ID_HEADER.lower()] + [(REQUEST_ID_HEADER,
                                                                      request_id)]
            return start_response(status, headers, exc_info)

        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except (TypeError, ValueError):
            length = 0

        start = time.perf_counter()
        try:
            result = app(environ, recording_start_response)
        except Exception:
            _counter(route, "5xx").inc()
            _finish()
            raise
        finally:
            if tspan is not None:
                tracing.finish_span(tspan,
                                    status=str(captured.get("status", "")).split(" ")[0])
            clear_request_id()
        elapsed = time.perf_counter() - start

        status = captured.get("status", "500")
        _counter(route, _code_class(status.split(" ")[0])).inc()
        _latency(route).observe(elapsed)
        if slo_window is not None and route == "/invocations":
            slo_window.observe_seconds(elapsed)
        if length:
            _payload(route).observe(length)
        return _TrackedBody(result, _finish) if tracker is not None else result

    return wrapped
