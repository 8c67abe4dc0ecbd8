"""Multi-model endpoint: the MMS front end's REST surface in one process.

The SageMaker XGBoost container serves multi-model endpoints through the
multi-model-server Java process and per-model Python workers. Here one
process owns the GPU, so the front end is a model manager behind the MMS
REST surface:

* ``POST   /models``                 {"model_name": n, "url": dir}  -> load
* ``GET    /models``                 -> list
* ``GET    /models/<name>``          -> describe
* ``DELETE /models/<name>``          -> unload
* ``POST   /models/<name>/invoke``   -> predict
* ``POST   /invocations``            -> predict, when exactly one model is
  loaded (400 otherwise)

Knobs, the MMS sizing contract:

* ``SAGEMAKER_MAX_MODELS``: an LRU cap; loading past it evicts the model
  invoked or loaded longest ago (default unlimited).
* ``SAGEMAKER_MAX_REQUEST_SIZE`` / ``MAX_CONTENT_LENGTH``: the payload cap,
  6 MB by default, hard-capped at MMS's 20 MB.
* ``SAGEMAKER_MODEL_JOB_QUEUE_SIZE``: each model's pending-request bound
  (default 100); beyond it an invoke gets 503.
* ``SAGEMAKER_NUM_MODEL_WORKERS``: accepted; concurrency comes from each
  model's request coalescer, so values other than 1 only log.

A loaded model's trees live on the device. Unloading or evicting a model
ends its batcher thread, waits for its warmup thread, drops its device
tensors and retires its batcher series, so model churn holds neither device
memory nor threads. The answers are the JAX package's ``make_mme_app``'s.
"""

import collections
import http.client
import json
import logging
import os
import threading
from urllib.parse import parse_qs

import numpy as np

from .._device import resolve_device
from ..data.content_types import get_content_type
from ..telemetry import REGISTRY, instrument_wsgi
from ..toolkit import exceptions as exc
from ..utils.envconfig import env_int
from ..utils.faults import fault_point
from . import lifecycle, serve_utils
from .app import _drain_response, _read_body, _response, _shed_response, parse_accept
from .batcher import JobQueueFull, PredictBatcher
from .breaker import CircuitBreaker
from .lifecycle import DeadlineExceeded

logger = logging.getLogger(__name__)

MAX_CONTENT_LEN_LIMIT = 20 * 1024**2  # the MMS hard cap


def _max_request_size():
    """SAGEMAKER_MAX_REQUEST_SIZE, else MAX_CONTENT_LENGTH, else 6MB, at
    most 20MB."""
    value = env_int("SAGEMAKER_MAX_REQUEST_SIZE", env_int("MAX_CONTENT_LENGTH", 6 * 1024**2))
    return min(value, MAX_CONTENT_LEN_LIMIT)


def _job_queue_size():
    return env_int("SAGEMAKER_MODEL_JOB_QUEUE_SIZE", 100)


# how long an unload waits for a model's batcher and warmup threads
_RELEASE_TIMEOUT_S = 30.0

Entry = collections.namedtuple("Entry", "model fmt model_dir batcher warmup")


class ModelManager:
    """The loaded models by name, in least-recently-used order, on
    ``device`` (CUDA unless given)."""

    def __init__(self, max_models=None, device=None):
        self.device = resolve_device(device)
        self._models = collections.OrderedDict()  # name -> Entry
        self._lock = threading.Lock()
        self.max_models = max_models or int(os.getenv("SAGEMAKER_MAX_MODELS", "0")) or None
        # one breaker for the endpoint: MME has no per-model /ping, so
        # saturation and a stuck dispatch degrade the whole endpoint, as the
        # MMS front end does
        self.breaker = CircuitBreaker(name="mme")

    def load(self, name, url):
        model_dir = url
        if not os.path.isdir(model_dir):
            raise FileNotFoundError("model url {} is not a directory".format(url))
        model, fmt = serve_utils.get_loaded_booster(
            model_dir, serve_utils.is_ensemble_enabled(), device=self.device)
        batcher = None
        if not isinstance(model, list):
            rng = serve_utils.best_iteration_range(model)
            batcher = PredictBatcher(
                lambda feats, _m=model, _r=rng: _m.predict(feats, iteration_range=_r),
                max_queue=_job_queue_size(),
                name=name,  # per-model series, bounded by the LRU cap
            )
        workers = os.getenv("SAGEMAKER_NUM_MODEL_WORKERS")
        if workers and workers != "1":
            logger.info("SAGEMAKER_NUM_MODEL_WORKERS=%s accepted; concurrency comes from each "
                        "model's request coalescing", workers)
        evicted = None
        with self._lock:
            duplicate = name in self._models
            if not duplicate:
                warmup = serve_utils.warmup_predict_async(model)
                self._models[name] = Entry(model, fmt, model_dir, batcher, warmup)
                if self.max_models and len(self._models) > self.max_models:
                    evicted = self._models.popitem(last=False)
                    _retire(evicted[0])
                if batcher is not None and name in self._models:
                    # the watchdog trips the endpoint's breaker: a wedged
                    # dispatch on any model wedges the one GPU owner
                    lifecycle.register_batcher(name, batcher, self.breaker)
        if duplicate:
            # the loaded model keeps the name and its series
            _release(name, Entry(model, fmt, model_dir, batcher, None))
            raise KeyError("model {} is already loaded".format(name))
        if evicted is not None:
            logger.info("Evicted model %s (LRU cap %d)", evicted[0], self.max_models)
            _release(*evicted)

    def unload(self, name):
        with self._lock:
            if name not in self._models:
                raise KeyError(name)
            entry = self._models.pop(name)
            _retire(name)
        _release(name, entry)

    def get(self, name):
        with self._lock:
            if name not in self._models:
                raise KeyError(name)
            self._models.move_to_end(name)
            return self._models[name]

    def list(self):
        with self._lock:
            return [{"modelName": name, "modelUrl": entry.model_dir}
                    for name, entry in self._models.items()]


def _retire(name):
    """A model's name leaves the endpoint: its batcher series (retired, so
    churn cannot grow the registry; a reload of the name starts afresh) and
    its watchdog registration go. Called under the manager's lock, so a
    reload of the name cannot interleave."""
    REGISTRY.remove_matching("batcher", name)
    lifecycle.unregister_batcher(name)


def _release(name, entry):
    """Let go of a model that left the endpoint: its batcher thread ends
    after the requests it holds, its warmup thread is waited for and its
    trees leave the device. A request still holding the entry answers all
    the same: it runs on its own thread and uploads the trees again."""
    if entry.batcher is not None and not entry.batcher.close(_RELEASE_TIMEOUT_S):
        logger.error("the batcher of model %s did not stop in %.0fs", name, _RELEASE_TIMEOUT_S)
    if entry.warmup is not None:
        entry.warmup.join(_RELEASE_TIMEOUT_S)
    for forest in entry.model if isinstance(entry.model, list) else [entry.model]:
        forest.release()


def make_mme_app(manager=None, device=None):
    """The MME WSGI app over ``manager`` (a new ModelManager on ``device``,
    CUDA unless given, when None)."""
    manager = manager or ModelManager(device=device)

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "/").rstrip("/")
        method = environ.get("REQUEST_METHOD", "GET")
        try:
            if path == "/ping" and method == "GET":
                if not lifecycle.accepting():
                    return _drain_response(start_response)
                lifecycle.observe(manager.breaker)
                if manager.breaker.degraded:
                    return _response(
                        start_response, http.client.SERVICE_UNAVAILABLE,
                        "degraded: shedding load",
                        extra_headers=[("Retry-After", str(manager.breaker.retry_after_s()))])
                return _response(start_response, http.client.OK,
                                 json.dumps({"status": "Healthy"}), "application/json")

            if path == "/models" and method == "GET":
                body = json.dumps({"models": manager.list()})
                return _response(start_response, http.client.OK, body, "application/json")

            if path == "/models" and method == "POST":
                params = _query_params(environ)
                if environ.get("CONTENT_TYPE", "").startswith("application/json"):
                    payload = json.loads(_read_body(environ) or b"{}")
                else:
                    payload = {}
                name = payload.get("model_name") or params.get("model_name")
                url = payload.get("url") or params.get("url")
                if not name or not url:
                    return _response(start_response, http.client.BAD_REQUEST,
                                     "model_name and url required")
                try:
                    manager.load(name, url)
                except KeyError as e:
                    return _response(start_response, http.client.CONFLICT, str(e))
                except FileNotFoundError as e:
                    return _response(start_response, http.client.NOT_FOUND, str(e))
                except Exception as e:
                    logger.exception("model load failed")
                    return _response(start_response, http.client.INTERNAL_SERVER_ERROR, str(e))
                return _response(
                    start_response, http.client.OK,
                    json.dumps({"status": "Workers scaled for model: " + name}),
                    "application/json")

            if path.startswith("/models/"):
                remainder = path[len("/models/"):]
                if remainder.endswith("/invoke"):
                    name = remainder[: -len("/invoke")]
                    if method != "POST":
                        return _response(start_response, http.client.METHOD_NOT_ALLOWED)
                    return _invoke(manager, name, environ, start_response)
                name = remainder
                if method == "GET":
                    try:
                        entry = manager.get(name)
                    except KeyError:
                        return _response(start_response, http.client.NOT_FOUND,
                                         "model not found")
                    body = json.dumps([{"modelName": name, "modelUrl": entry.model_dir,
                                        "format": entry.fmt}])
                    return _response(start_response, http.client.OK, body, "application/json")
                if method == "DELETE":
                    try:
                        manager.unload(name)
                    except KeyError:
                        return _response(start_response, http.client.NOT_FOUND,
                                         "model not found")
                    return _response(
                        start_response, http.client.OK,
                        json.dumps({"status": "Model \"{}\" unregistered".format(name)}),
                        "application/json")
            # the single-model route, while exactly one model is loaded
            if path == "/invocations" and method == "POST":
                models = manager.list()
                if len(models) != 1:
                    return _response(start_response, http.client.BAD_REQUEST,
                                     "multi-model endpoint: use /models/<name>/invoke")
                return _invoke(manager, models[0]["modelName"], environ, start_response)
            return _response(start_response, http.client.NOT_FOUND, "not found")
        except DeadlineExceeded as e:
            # a decode- or encode-stage expiry (predict-stage ones are handled
            # in _invoke): the saturation protocol, not a client error
            logger.warning("request deadline exceeded: %s", e)
            manager.breaker.record_saturation()
            return _shed_response(start_response, manager.breaker, str(e))
        except Exception as e:
            logger.exception("unhandled MME error")
            return _response(start_response, http.client.INTERNAL_SERVER_ERROR, str(e))

    wrapped = instrument_wsgi(app)
    wrapped.manager = manager
    return wrapped


def _query_params(environ):
    qs = parse_qs(environ.get("QUERY_STRING", ""))
    return {k: v[0] for k, v in qs.items()}


def _invoke(manager, name, environ, start_response):
    if not lifecycle.accepting():
        return _drain_response(start_response)
    if not manager.breaker.allow():
        # an open breaker (saturation or a stuck dispatch) sheds before the
        # decode, endpoint-wide
        return _shed_response(start_response, manager.breaker, "shedding load")
    deadline = lifecycle.request_deadline()
    try:
        entry = manager.get(name)
    except KeyError:
        return _response(start_response, http.client.NOT_FOUND, "model not found")
    model, batcher = entry.model, entry.batcher
    try:
        payload = _read_body(environ, limit=_max_request_size())
    except exc.UserError as e:
        return _response(start_response, http.client.REQUEST_ENTITY_TOO_LARGE, str(e))
    if not payload:
        return _response(start_response, http.client.NO_CONTENT)
    content_type = environ.get("CONTENT_TYPE", "text/csv")
    try:
        dtest, parsed_type = serve_utils.parse_content_data(payload, content_type)
    except Exception as e:
        return _response(start_response, http.client.UNSUPPORTED_MEDIA_TYPE, str(e))
    if deadline is not None:
        deadline.check("decode")
    try:
        accept = parse_accept(environ)
    except ValueError as e:
        return _response(start_response, http.client.NOT_ACCEPTABLE, str(e))
    try:
        fault_point("predict.dispatch", model=name, content_type=parsed_type)
        first = model[0] if isinstance(model, list) else model
        if batcher is not None:
            serve_utils._check_feature_count(first, dtest, get_content_type(parsed_type))
            feats = serve_utils.canonicalize_features(first, dtest)
            preds = batcher.predict(feats, deadline=deadline)
            serve_utils.observe_drift(feats, preds)
        else:
            preds = serve_utils.predict(model, entry.fmt, dtest, parsed_type,
                                        objective=first.objective_name)
            if deadline is not None:
                deadline.check("predict")
    except (JobQueueFull, TimeoutError) as e:
        # saturation (a per-stage deadline expiry too): 503 + Retry-After,
        # feeding the endpoint's breaker
        manager.breaker.record_saturation()
        return _shed_response(start_response, manager.breaker, str(e))
    except Exception as e:
        logger.exception("invoke predict failed")
        return _response(start_response, http.client.BAD_REQUEST, str(e))
    fault_point("serving.encode", model=name, accept=accept)
    if deadline is not None:
        deadline.check("encode")
    # success only after the deadline cleared, or an encode-expiry storm
    # could never open the breaker
    manager.breaker.record_success()
    preds_list = np.asarray(preds).tolist()
    if accept == "application/json":
        body = serve_utils.encode_predictions_as_json(preds_list)
    else:
        body = "\n".join(
            ",".join(map(str, p)) if isinstance(p, list) else str(p) for p in preds_list)
    return _response(start_response, http.client.OK, body, accept)
