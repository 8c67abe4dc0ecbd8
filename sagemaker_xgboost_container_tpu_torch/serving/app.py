"""The scoring WSGI application: /ping, /invocations, /execution-parameters.

Status codes: 204 on an empty payload, 415 on undecodable content, 400 on a
payload the model cannot evaluate, 406 on a bad accept, 413 above
MAX_CONTENT_LENGTH (6 MB by default), 500 on a model-load failure and on an
error of the torch runtime during predict, 503 + Retry-After on
saturation. Accept negotiation falls back to
SAGEMAKER_DEFAULT_INVOCATIONS_ACCEPT (default text/csv).

A dependency-free WSGI callable, served by the threaded server in
``server.py``. One process owns the GPU; request threads share the forest
on the device.
"""

import http.client
import json
import logging
import multiprocessing
import os
import threading

import numpy as np

from .. import constants
from .._device import resolve_device
from ..data.content_types import get_content_type
from ..data.recordio import write_recordio_protobuf
from ..toolkit import exceptions as exc
from ..utils.envconfig import env_int
from . import serve_utils
from .batcher import JobQueueFull, PredictBatcher
from .breaker import CircuitBreaker

logger = logging.getLogger(__name__)

SUPPORTED_ACCEPTS = [
    "application/json",
    "application/jsonlines",
    "application/x-recordio-protobuf",
    "text/csv",
]

PARSED_MAX_CONTENT_LENGTH = int(os.getenv("MAX_CONTENT_LENGTH", "6291456"))


def number_of_workers():
    return multiprocessing.cpu_count()


class ScoringService:
    """Lazy model holder for the single-model endpoint.

    ``device``: where the model predicts, CUDA unless given; raises here
    when CUDA is asked for and absent.
    """

    def __init__(self, model_dir=None, device=None):
        self.model_dir = model_dir or os.getenv(constants.SM_MODEL_DIR, "/opt/ml/model")
        self.device = resolve_device(device)
        self.model = None
        self.model_format = None
        self.batcher = None
        self.warmup = None  # the warmup thread, once the model is loaded
        self._load_lock = threading.Lock()
        self.breaker = CircuitBreaker()

    def load_model(self):
        # lock: concurrent first requests on the threaded server must not
        # each load the model
        with self._load_lock:
            if self.model is None:
                self.model, self.model_format = serve_utils.get_loaded_booster(
                    self.model_dir, serve_utils.is_ensemble_enabled(), device=self.device
                )
                if not isinstance(self.model, list) and os.getenv(
                    "SAGEMAKER_SERVING_BATCHING", "true"
                ).lower() == "true":
                    model = self.model
                    rng = serve_utils.best_iteration_range(model)
                    # bounded queue: JobQueueFull is what lets the circuit
                    # breaker shed load instead of queueing into timeouts
                    self.batcher = PredictBatcher(
                        lambda feats: model.predict(feats, iteration_range=rng),
                        max_queue=env_int("SAGEMAKER_MODEL_JOB_QUEUE_SIZE", 100, minimum=1),
                    )
                self.warmup = serve_utils.warmup_predict_async(self.model)
        return self.model_format

    @property
    def objective(self):
        model = self.model[0] if isinstance(self.model, list) else self.model
        return model.objective_name if model else None

    @property
    def num_class(self):
        model = self.model[0] if isinstance(self.model, list) else self.model
        return str(model.num_class or "") if model else ""

    def predict(self, dtest, content_type):
        if self.batcher is not None:
            serve_utils._check_feature_count(self.model, dtest, get_content_type(content_type))
            return self.batcher.predict(serve_utils.canonicalize_features(self.model, dtest))
        return serve_utils.predict(
            self.model, self.model_format, dtest, content_type, objective=self.objective
        )


def _response(start_response, status, body=b"", content_type="text/plain", extra_headers=None):
    if isinstance(body, str):
        body = body.encode("utf-8")
    headers = [("Content-Type", content_type), ("Content-Length", str(len(body)))]
    if extra_headers:
        headers.extend(extra_headers)
    start_response(
        "{} {}".format(status, http.client.responses.get(status, "")),
        headers,
    )
    return [body]


def _shed_response(start_response, breaker, detail):
    """503 + Retry-After: the load-shedding contract."""
    return _response(
        start_response,
        http.client.SERVICE_UNAVAILABLE,
        "Temporarily overloaded: {}. Retry after the indicated delay.".format(detail),
        extra_headers=[("Retry-After", str(breaker.retry_after_s()))],
    )


def parse_accept(environ):
    accept = environ.get("HTTP_ACCEPT", "").split(";")[0].strip().lower()
    if not accept or accept == "*/*":
        return os.getenv(constants.SAGEMAKER_DEFAULT_INVOCATIONS_ACCEPT, "text/csv")
    if accept not in SUPPORTED_ACCEPTS:
        raise ValueError(
            "Accept type {} is not supported. Please use supported accept types: {}.".format(
                accept, SUPPORTED_ACCEPTS
            )
        )
    return accept


def _read_body(environ):
    try:
        length = int(environ.get("CONTENT_LENGTH") or 0)
    except ValueError:
        length = 0
    if length > PARSED_MAX_CONTENT_LENGTH:
        raise exc.UserError("Payload too large")
    return environ["wsgi.input"].read(length) if length else b""


def _encode(preds, accept):
    preds_list = np.asarray(preds).tolist()
    if os.getenv(constants.SAGEMAKER_BATCH):
        return "\n".join(map(str, preds_list)) + "\n"
    if accept == "application/json":
        return serve_utils.encode_predictions_as_json(preds_list)
    if accept == "application/jsonlines":
        return serve_utils.encode_selected_predictions(
            [{"score": p} for p in preds_list], ["score"], accept
        )
    if accept == "application/x-recordio-protobuf":
        return write_recordio_protobuf(
            np.asarray(preds_list, np.float32).reshape(len(preds_list), -1)
        )
    return "\n".join(
        ",".join(map(str, p)) if isinstance(p, list) else str(p) for p in preds_list
    )


def make_app(scoring_service=None, hooks=None):
    """Build the WSGI callable.

    hooks: optional script-mode override dict with any of model_fn/input_fn/
    predict_fn/output_fn/transform_fn.
    """
    service = scoring_service or ScoringService()
    hooks = hooks or {}
    # duck-typed services (tests, script-mode shims) may not carry one
    breaker = getattr(service, "breaker", None)

    def handle_invocations(environ, start_response):
        if breaker is not None and not breaker.allow():
            # open breaker: shed before decode, so a drowning instance stops
            # paying per-request parse costs
            return _shed_response(start_response, breaker, "shedding load")
        payload = _read_body(environ)
        if len(payload) == 0:
            return _response(start_response, http.client.NO_CONTENT)
        content_type = environ.get("CONTENT_TYPE", "text/csv")

        try:
            accept = parse_accept(environ)
        except ValueError as e:
            return _response(start_response, http.client.NOT_ACCEPTABLE, str(e))

        if "transform_fn" in hooks:
            try:
                model = _hooked_model(service, hooks)
                result, out_type = hooks["transform_fn"](model, payload, content_type, accept)
                return _response(start_response, http.client.OK, result, out_type)
            except Exception as e:
                logger.exception("transform_fn failed")
                return _response(start_response, http.client.BAD_REQUEST, str(e))

        try:
            if "input_fn" in hooks:
                dtest = hooks["input_fn"](payload, content_type)
                parsed_type = content_type.split(";")[0]
            else:
                dtest, parsed_type = serve_utils.parse_content_data(payload, content_type)
        except Exception as e:
            logger.exception("decode failed")
            return _response(start_response, http.client.UNSUPPORTED_MEDIA_TYPE, str(e))

        try:
            model = _hooked_model(service, hooks)
        except Exception as e:
            logger.exception("model load failed")
            return _response(
                start_response,
                http.client.INTERNAL_SERVER_ERROR,
                "Unable to load model: %s" % e,
            )

        try:
            if "predict_fn" in hooks:
                preds = hooks["predict_fn"](dtest, model)
            else:
                preds = service.predict(dtest, parsed_type)
        except (JobQueueFull, TimeoutError) as e:
            # saturation, not a client error: 503 + Retry-After, and feed the
            # breaker so a sustained storm flips /ping and sheds pre-decode
            logger.warning("predict saturated: %s", e)
            if breaker is not None:
                breaker.record_saturation()
                return _shed_response(start_response, breaker, str(e))
            return _response(start_response, http.client.SERVICE_UNAVAILABLE, str(e))
        except RuntimeError as e:
            # the torch runtime raises RuntimeError (and its subclasses) for
            # device faults: the server's failure, never the payload's, and
            # never retried on the host
            logger.exception("predict failed in the torch runtime")
            return _response(
                start_response,
                http.client.INTERNAL_SERVER_ERROR,
                "Prediction failed on the device: %s" % e,
            )
        except Exception as e:
            logger.exception("predict failed")
            return _response(
                start_response,
                http.client.BAD_REQUEST,
                "Unable to evaluate payload provided: %s" % e,
            )
        if breaker is not None:
            breaker.record_success()

        if "output_fn" in hooks:
            try:
                body, out_type = hooks["output_fn"](preds, accept)
                return _response(start_response, http.client.OK, body, out_type)
            except Exception as e:
                return _response(start_response, http.client.INTERNAL_SERVER_ERROR, str(e))

        if serve_utils.is_selectable_inference_output():
            try:
                keys = serve_utils.get_selected_output_keys()
                selected = serve_utils.get_selected_predictions(
                    preds, keys, service.objective, num_class=service.num_class
                )
                body = serve_utils.encode_selected_predictions(selected, keys, accept)
                return _response(start_response, http.client.OK, body, accept)
            except Exception as e:
                logger.exception("selectable inference failed")
                return _response(start_response, http.client.INTERNAL_SERVER_ERROR, str(e))

        return _response(start_response, http.client.OK, _encode(preds, accept), accept)

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        method = environ.get("REQUEST_METHOD", "GET")
        try:
            if path == "/ping" and method == "GET":
                if breaker is not None and breaker.degraded:
                    # unready while shedding: the platform should stop
                    # routing to this instance until it recovers
                    return _response(
                        start_response,
                        http.client.SERVICE_UNAVAILABLE,
                        "degraded: shedding load",
                        extra_headers=[("Retry-After", str(breaker.retry_after_s()))],
                    )
                try:
                    _hooked_model(service, hooks)
                    return _response(start_response, http.client.OK)
                except Exception as e:
                    logger.exception("ping model load failed")
                    return _response(
                        start_response, http.client.INTERNAL_SERVER_ERROR, str(e)
                    )
            if path == "/execution-parameters" and method == "GET":
                parameters = {
                    "MaxConcurrentTransforms": number_of_workers(),
                    "BatchStrategy": "MULTI_RECORD",
                    "MaxPayloadInMB": int(PARSED_MAX_CONTENT_LENGTH / (1024**2)),
                }
                return _response(
                    start_response,
                    http.client.OK,
                    json.dumps(parameters),
                    "application/json",
                )
            if path == "/invocations" and method == "POST":
                return handle_invocations(environ, start_response)
            return _response(start_response, http.client.NOT_FOUND, "not found")
        except exc.UserError as e:
            return _response(start_response, http.client.REQUEST_ENTITY_TOO_LARGE, str(e))
        except Exception as e:  # last-resort 500
            logger.exception("unhandled serving error")
            return _response(start_response, http.client.INTERNAL_SERVER_ERROR, str(e))

    app.service = service
    return app


def _hooked_model(service, hooks):
    if "model_fn" in hooks:
        if service.model is None:
            service.model = hooks["model_fn"](service.model_dir)
            service.model_format = "user"
        return service.model
    service.load_model()
    return service.model
