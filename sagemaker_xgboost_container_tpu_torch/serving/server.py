"""The ``serve`` entrypoint: threaded WSGI server over the scoring app.

One process owns the GPU and a thread per connection handles HTTP. The app
is the single-model scoring app (``app.py``); a user inference module named
by SAGEMAKER_PROGRAM overrides its handlers with its model_fn / input_fn /
predict_fn / output_fn / transform_fn. The multi-model endpoint
(SAGEMAKER_MULTI_MODEL=true) is not ported yet.

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
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

from .. import constants
from ..toolkit import exceptions as exc
from ..utils.logging_config import setup_main_logger
from .app import ScoringService, make_app

logger = logging.getLogger(__name__)

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

    The script dir lands on ``sys.path`` (user scripts import sibling
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
    """The single-model scoring app over SM_MODEL_DIR, on ``device`` (CUDA
    unless given)."""
    if is_multi_model():
        raise exc.UserError(
            "SAGEMAKER_MULTI_MODEL=true: the multi-model endpoint is not ported "
            "to the PyTorch package yet"
        )
    model_dir = os.getenv(constants.SM_MODEL_DIR, "/opt/ml/model")
    hooks = _load_user_hooks(model_dir)
    return make_app(ScoringService(model_dir, device=device), hooks=hooks)


def serving_entrypoint(port=None, block=True, device=None):
    """Serve the scoring app on ``port`` (SAGEMAKER_BIND_TO_PORT, else 8080,
    when None; 0 picks a free port), predicting on ``device`` (CUDA unless
    given). SIGTERM shuts the server down (``_ThreadedWSGIServer.stop``).

    block=True serves until then; block=False returns the server unserved,
    for the caller to run ``serve_forever`` on a thread of its own.
    """
    set_default_serving_env_if_unspecified()
    setup_main_logger(__name__)
    if port is None:
        port = int(os.getenv("SAGEMAKER_BIND_TO_PORT", 8080))
    app = build_app(device=device)
    httpd = make_server(
        "0.0.0.0", int(port), app, server_class=_ThreadedWSGIServer,
        handler_class=_QuietHandler,
    )
    shutdown_state = {"thread": None}
    shutdown_lock = threading.Lock()

    def _on_sigterm(signo, frame):
        # the handler runs on the main thread, which may be inside
        # serve_forever: httpd.shutdown() would deadlock there, so a
        # separate thread does it
        logger.info("Received signal %s, shutting down", signo)
        with shutdown_lock:
            if shutdown_state["thread"] is not None:
                return  # duplicate SIGTERM
            shutdown_state["thread"] = threading.Thread(
                target=httpd.stop, daemon=True, name="serving-shutdown"
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
