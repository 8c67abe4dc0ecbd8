"""Where the port keeps what it compiles (``GRAFT_COMPILE_CACHE_DIR``).

Two libraries are built at first use and cached by a digest of their
sources: the CUDA kernels (``_build.py``, ``torch_kernels/<key>/``) and the
native data plane (``data/native.py``, ``torch_native/<key>/``). Both live
under one root: ``GRAFT_COMPILE_CACHE_DIR`` when it is set, else
``build/`` beside the package. An installed package's parent is
``site-packages``, so a job (and every child process it starts) that wants
its builds kept names a directory of its own with the knob.

The knob is resolved once a process, at the first build or load, so every
library of one process comes from one root. A directory that cannot be
created or written degrades to a logged warning and the default root, never
a failed job (the JAX package's ``compile_cache`` does the same).
"""

import logging
import os
import tempfile
import threading

logger = logging.getLogger(__name__)

COMPILE_CACHE_ENV = "GRAFT_COMPILE_CACHE_DIR"
DEFAULT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build")

_lock = threading.Lock()
_resolved = None  # None = not yet resolved; "" = resolved to the default


def maybe_enable_compile_cache():
    """The knob's directory when it is set and writable, else None.

    Process-once: the first call resolves ``GRAFT_COMPILE_CACHE_DIR`` and
    every later call returns the same answer (changing the variable later
    in the process has no effect)."""
    global _resolved
    with _lock:
        if _resolved is None:
            _resolved = _resolve()
        return _resolved or None


def _resolve():
    # graftlint: disable=capture-env-read not captured: reached from the round only
    # through a failed collective's abort (across ranks, which run eagerly) or the
    # kernels' first build (the eager warm-up round)
    path = os.environ.get(COMPILE_CACHE_ENV, "").strip()
    if not path:
        return ""
    try:
        os.makedirs(path, exist_ok=True)
        fd, probe = tempfile.mkstemp(dir=path, prefix=".probe.")
        os.close(fd)
        os.remove(probe)
    except OSError as e:
        logger.warning("%s=%r cannot be used (%s); building under %s",
                       COMPILE_CACHE_ENV, path, e, DEFAULT_ROOT)
        return ""
    logger.info("compile cache at %s", path)
    return os.path.abspath(path)


def cache_dir(name):
    """``<root>/<name>``: the cache directory of one library."""
    return os.path.join(maybe_enable_compile_cache() or DEFAULT_ROOT, name)


def _reset_for_tests():
    global _resolved
    with _lock:
        _resolved = None
