"""The ``serve`` entrypoint: threaded WSGI server, mode dispatch, SIGTERM
drain.

One process owns the GPU and a thread per connection handles HTTP. The app
is

* SAGEMAKER_MULTI_MODEL=true: the multi-model endpoint (``mme.py``);
* otherwise the single-model scoring app (``app.py``), whose handlers a
  user inference module named by SAGEMAKER_PROGRAM overrides with its
  model_fn / input_fn / predict_fn / output_fn / transform_fn.

A serving lifecycle (``lifecycle.py``) is installed first: readiness,
the in-flight latch, request deadlines and the predict watchdog. SIGTERM
drains (``drain_and_shutdown``). ``SM_METRICS_EMIT_INTERVAL_S`` starts a
reporter of ``serving.snapshot`` records.

``OMP_NUM_THREADS`` defaults to 1, as in the SageMaker XGBoost container,
so host-side work doesn't oversubscribe the instance.

Run it as ``python -m sagemaker_xgboost_container_tpu_torch.serving.server``.
"""

import hashlib
import importlib.util
import logging
import os
import signal
import sys
import threading
import time
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

from .. import constants
from .. import telemetry
from ..constants import EXIT_DRAIN_TIMEOUT
from ..utils.envconfig import env_float
from ..utils.logging_config import setup_main_logger
from ..utils.requirements import install_requirements_if_present
from . import lifecycle as lifecycle_mod
from .app import ScoringService, make_app
from .mme import make_mme_app

logger = logging.getLogger(__name__)

METRICS_INTERVAL_ENV = "SM_METRICS_EMIT_INTERVAL_S"

HOOK_NAMES = ("model_fn", "input_fn", "predict_fn", "output_fn", "transform_fn")


class _ThreadedWSGIServer(ThreadingMixIn, WSGIServer):
    # request threads are joined by server_close(), so a shutdown lets every
    # request that was accepted finish writing its answer
    daemon_threads = False
    block_on_close = True
    allow_reuse_address = True
    # socketserver's default listen backlog of 5 resets concurrent connects
    # beyond it
    request_queue_size = 2048

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.stopped = threading.Event()

    def stop(self):
        """Stop the accept loop, close the listener, then wait for the
        requests already accepted to finish writing their answers. Needs the
        serve loop running on another thread; sets ``stopped`` when done."""
        self.shutdown()
        self.server_close()
        self.stopped.set()


class _QuietHandler(WSGIRequestHandler):
    # bounds how long an idle connection can hold server_close()
    timeout = 60

    def log_message(self, format, *args):  # route access logs through logging
        logger.debug("%s - %s", self.address_string(), format % args)


def set_default_serving_env_if_unspecified():
    os.environ.setdefault("OMP_NUM_THREADS", constants.ONE_THREAD_PER_PROCESS)


def is_multi_model():
    return os.environ.get("SAGEMAKER_MULTI_MODEL", "").lower() == "true"


def _load_user_hooks(model_dir):
    """Import the customer's inference script if present; return hook dict.

    A ``requirements.txt`` beside the script is pip-installed first
    (``utils/requirements``). The script dir lands on ``sys.path`` (user scripts import sibling
    helpers, lazily too, so a successful load keeps it), and the module
    registers in ``sys.modules`` under a name derived from the script path
    (pickle and dataclass machinery resolve classes through it). A failed
    exec rolls both back, so a broken script can't poison a retried load.
    """
    program = os.environ.get("SAGEMAKER_PROGRAM")
    candidates = []
    if program:
        for base in (
            os.environ.get("SAGEMAKER_SUBMIT_DIRECTORY", ""),
            os.path.join(model_dir, "code"),
            model_dir,
        ):
            if base:
                candidates.append(os.path.join(base, program))
    script = next((c for c in candidates if os.path.isfile(c)), None)
    if script is None:
        return {}
    script_dir = os.path.dirname(script)
    # the script's requirements.txt, before the script imports them
    install_requirements_if_present(script_dir)
    module_name = "user_inference_{}".format(
        hashlib.sha1(os.path.abspath(script).encode("utf-8")).hexdigest()[:12]
    )
    spec = importlib.util.spec_from_file_location(module_name, script)
    module = importlib.util.module_from_spec(spec)
    inserted = script_dir not in sys.path
    if inserted:
        sys.path.insert(0, script_dir)
    sys.modules[module_name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        sys.modules.pop(module_name, None)
        if inserted:
            try:
                sys.path.remove(script_dir)
            except ValueError:
                pass
        raise
    hooks = {name: getattr(module, name) for name in HOOK_NAMES if hasattr(module, name)}
    logger.info("Loaded user serving hooks from %s: %s", script, sorted(hooks))
    return hooks


def build_app(device=None):
    """The app on ``device`` (CUDA unless given): the multi-model endpoint
    when SAGEMAKER_MULTI_MODEL=true, else the single-model scoring app over
    SM_MODEL_DIR."""
    if is_multi_model():
        logger.info("Starting multi-model endpoint manager")
        app = make_mme_app(device=device)
        # an MME starts empty (models arrive by POST /models): no load to
        # gate readiness on
        lifecycle_mod.mark_ready()
        return app
    model_dir = os.getenv(constants.SM_MODEL_DIR, "/opt/ml/model")
    hooks = _load_user_hooks(model_dir)
    return make_app(ScoringService(model_dir, device=device), hooks=hooks)


class MetricsReporter:
    """A stoppable thread emitting one ``serving.snapshot`` record of the
    registry every ``interval`` seconds."""

    def __init__(self, interval, registry):
        self.interval = interval
        self._registry = registry
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="metrics-reporter")

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                telemetry.emit_metric("serving.snapshot",
                                      **telemetry.snapshot_fields(self._registry))
            except Exception:
                logger.exception("metrics reporter failed; continuing")


def start_metrics_reporter(interval=None, registry=None):
    """Start a reporter every ``SM_METRICS_EMIT_INTERVAL_S`` seconds (the
    CloudWatch-scrapable view of the serving metrics). Off by default
    (unset, 0 or malformed). -> its stop handle, or None."""
    if interval is None:
        interval = env_float(METRICS_INTERVAL_ENV, 0.0, minimum=0.0)
    if interval <= 0:
        return None
    reporter = MetricsReporter(interval, registry or telemetry.REGISTRY).start()
    logger.info("Emitting serving metric snapshots every %.1fs", interval)
    return reporter


def drain_and_shutdown(httpd, lifecycle, reporter=None):
    """Settle in-flight work, then close the listener (the SIGTERM contract):

    1. ``begin_drain()``: /ping and new work answer 503 + Retry-After, so
       the load balancer deregisters. The listener stays open: a connect
       that raced the drain gets an orderly 503, never a reset.
    2. In-flight requests (response bodies written) get
       ``SM_DRAIN_TIMEOUT_S`` to finish.
    3. Drained: stop the accept loop and close the listener
       (``httpd.stop()``). Still wedged past the timeout: flight-recorder
       dump, one ``serving.abort`` record, exit 83 (``EXIT_DRAIN_TIMEOUT``).

    ``SM_GRACEFUL_DRAIN=false`` skips the wait but still stops in order.
    Returns True on a clean drain (False only from the tests' fake exit).
    """
    drain_start = time.monotonic()
    if lifecycle is not None and lifecycle.graceful_drain:
        lifecycle.begin_drain()
        drained = lifecycle.wait_drained(lifecycle.drain_timeout_s)
        lifecycle.observe_drain_seconds(time.monotonic() - drain_start)
        if not drained:
            logger.error("drain timed out after %.1fs with %d request(s) still in flight; "
                         "exiting %d for a clean restart", lifecycle.drain_timeout_s,
                         lifecycle.inflight, EXIT_DRAIN_TIMEOUT)
            if reporter is not None:
                reporter.stop(timeout=2.0)
            lifecycle_mod.abort_serving("drain_timeout", EXIT_DRAIN_TIMEOUT,
                                        inflight=lifecycle.inflight,
                                        drain_timeout_s=lifecycle.drain_timeout_s)
            return False  # reached only when the exit is faked
        logger.info("drain complete in %.2fs; closing the listener",
                    time.monotonic() - drain_start)
    elif lifecycle is not None:
        lifecycle.begin_drain()  # /ping still flips for the shutdown window
        logger.info("graceful drain disabled (%s=false): immediate shutdown",
                    lifecycle_mod.GRACEFUL_DRAIN_ENV)
    if reporter is not None:
        reporter.stop(timeout=2.0)
    httpd.stop()
    if lifecycle is not None:
        lifecycle.mark_stopped()
    return True


def serving_entrypoint(port=None, block=True, device=None):
    """Serve on ``port`` (SAGEMAKER_BIND_TO_PORT, else 8080, when None; 0
    picks a free port), predicting on ``device`` (CUDA unless given).
    SIGTERM drains and shuts the server down (``drain_and_shutdown``).

    block=True serves until then; block=False returns the server unserved,
    for the caller to run ``serve_forever`` on a thread of its own.
    """
    set_default_serving_env_if_unspecified()
    setup_main_logger(__name__)
    if port is None:
        port = int(os.getenv("SAGEMAKER_BIND_TO_PORT", 8080))
    # RSS / fds / threads / device-bytes gauges for /metrics and the
    # snapshot records, from start-up on
    telemetry.register_runtime_gauges()
    # state machine, in-flight latch and (env-gated) predict watchdog; the
    # knobs resolve once, here
    lifecycle = lifecycle_mod.install(lifecycle_mod.ServingLifecycle())
    app = build_app(device=device)
    # the SLO window (armed in build_app when SM_SLO_P95_MS is set) counts
    # toward the degraded state without flipping /ping
    slo_window = telemetry.slo.active_window()
    if slo_window is not None:
        lifecycle_mod.observe(slo_window)
    logger.info("GET /metrics is %s (gate: %s=true)",
                "enabled" if telemetry.metrics_endpoint_enabled() else "disabled",
                telemetry.METRICS_ENDPOINT_ENV)
    reporter = start_metrics_reporter()
    httpd = make_server(
        "0.0.0.0", int(port), app, server_class=_ThreadedWSGIServer,
        handler_class=_QuietHandler,
    )
    shutdown_state = {"thread": None}
    shutdown_lock = threading.Lock()

    def _on_sigterm(signo, frame):
        # the handler runs on the main thread, which may be inside
        # serve_forever: the drain's wait and httpd.shutdown() would
        # deadlock there, so a separate thread does both while the serve
        # loop keeps answering
        logger.info("Received signal %s, draining before shutdown", signo)
        with shutdown_lock:
            if shutdown_state["thread"] is not None:
                return  # duplicate SIGTERM
            shutdown_state["thread"] = threading.Thread(
                target=drain_and_shutdown, args=(httpd, lifecycle),
                kwargs={"reporter": reporter}, daemon=True, name="serving-drain",
            )
            shutdown_state["thread"].start()

    signal.signal(signal.SIGTERM, _on_sigterm)
    logger.info("Serving on port %d", httpd.server_port)
    if block:
        httpd.serve_forever()
        httpd.stopped.wait()
    return httpd


def main():
    serving_entrypoint()


if __name__ == "__main__":
    main()
