"""Per-request correlation ids for the serving path.

Every request gets one id:

* the client's when it sends one: ``X-Request-Id``, or a ``request_id=`` /
  ``trace_id=`` pair inside ``X-Amzn-SageMaker-Custom-Attributes``;
* a fresh uuid4 hex otherwise.

It lives in a thread-local for the request (the threaded server runs one
request a thread, and the batcher's warnings fire on the request's thread),
is echoed in the ``X-Request-Id`` response header, and is attached to every
log record of the request thread by :class:`RequestIdFilter`.
"""

import logging
import re
import threading
import uuid

REQUEST_ID_HEADER = "X-Request-Id"
CUSTOM_ATTRIBUTES_HEADER = "X-Amzn-SageMaker-Custom-Attributes"

_ENV_REQUEST_ID = "HTTP_X_REQUEST_ID"
_ENV_CUSTOM_ATTRIBUTES = "HTTP_X_AMZN_SAGEMAKER_CUSTOM_ATTRIBUTES"

# ids become log fields and response headers: a safe charset and a bounded
# length, so a hostile header cannot inject log lines
_SAFE_ID = re.compile(r"[^A-Za-z0-9._-]")
_MAX_ID_LEN = 64

_CUSTOM_ATTR_KEYS = ("request_id", "trace_id")

_tls = threading.local()


def new_request_id():
    return uuid.uuid4().hex


def _sanitize(raw):
    if not raw:
        return None
    cleaned = _SAFE_ID.sub("", str(raw).strip())[:_MAX_ID_LEN]
    return cleaned or None


def extract_request_id(environ):
    """The request id of a WSGI request: the client's when present, else a
    new one. Always a non-empty safe string."""
    rid = _sanitize(environ.get(_ENV_REQUEST_ID))
    if rid:
        return rid
    attrs = environ.get(_ENV_CUSTOM_ATTRIBUTES, "")
    if attrs:
        for part in attrs.split(","):
            key, _, value = part.partition("=")
            if key.strip().lower() in _CUSTOM_ATTR_KEYS:
                rid = _sanitize(value)
                if rid:
                    return rid
    return new_request_id()


def set_request_id(rid):
    _tls.request_id = rid


def get_request_id():
    """The current thread's request id, or None outside a request."""
    return getattr(_tls, "request_id", None)


def clear_request_id():
    _tls.request_id = None


class RequestIdFilter(logging.Filter):
    """Attach the active request id to log records: ``record.request_id``
    (``-`` outside a request), and a ``[rid=...]`` suffix on the message
    while a request is active. Idempotent across handlers."""

    def filter(self, record):
        rid = get_request_id()
        record.request_id = rid or "-"
        if rid and not getattr(record, "_rid_tagged", False):
            record._rid_tagged = True
            record.msg = "{} [rid={}]".format(record.msg, rid)
        return True
