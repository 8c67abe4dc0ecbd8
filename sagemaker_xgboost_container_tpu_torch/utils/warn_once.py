"""Process-wide warn-once guard.

Shared by modules that log a condition the first time only (further hits
stay visible through metrics, not log spam). Key by a module-prefixed
string (``"ingest.empty_files"``) so unrelated callers never collide.
"""

import threading

_lock = threading.Lock()
_seen = set()


def warn_once(log, key, message, *args):
    """Log ``message`` via ``log.warning`` the first time ``key`` is seen
    in this process; later calls are silent. -> True when it logged."""
    with _lock:
        if key in _seen:
            return False
        _seen.add(key)
    log.warning(message, *args)
    return True


def reset_warnings():
    """Test hook: forget every key (the next warn_once fires again)."""
    with _lock:
        _seen.clear()
