"""Defensive env-var parsing for operational knobs.

Serving knobs are tuning levers, not correctness inputs: a typo in one must
degrade to the default, never turn into a per-request exception. A
malformed value logs one warning per variable per process (warn-once).
Out-of-range values clamp to the violated bound.
"""

import logging
import math
import os
import threading

logger = logging.getLogger(__name__)

_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")

_warn_lock = threading.Lock()
_warned = set()


def _warn_once(name, raw, expected, used):
    with _warn_lock:
        if name in _warned:
            return
        _warned.add(name)
    logger.warning(
        "ignoring malformed %s=%r (expected %s); using %r", name, raw, expected, used
    )


def _clamp(name, raw, value, minimum, maximum):
    if minimum is not None and value < minimum:
        _warn_once(name, raw, ">= {}".format(minimum), minimum)
        return minimum
    if maximum is not None and value > maximum:
        _warn_once(name, raw, "<= {}".format(maximum), maximum)
        return maximum
    return value


def env_int(name, default, minimum=None, maximum=None):
    """int(os.environ[name]) with fallback to ``default`` on absent,
    empty, or malformed values; out-of-range values clamp (warn-once)."""
    raw = os.getenv(name)
    if raw is None or raw == "":
        return default
    try:
        value = int(raw)
    except ValueError:
        _warn_once(name, raw, "an integer", default)
        return default
    return _clamp(name, raw, value, minimum, maximum)


def env_float(name, default, minimum=None, maximum=None):
    """float(os.environ[name]) with fallback to ``default`` on absent,
    empty, malformed or non-finite values; out-of-range values clamp
    (warn-once)."""
    raw = os.getenv(name)
    if raw is None or raw == "":
        return default
    try:
        value = float(raw)
    except ValueError:
        _warn_once(name, raw, "a number", default)
        return default
    if not math.isfinite(value):  # _clamp cannot catch NaN
        _warn_once(name, raw, "a finite number", default)
        return default
    return _clamp(name, raw, value, minimum, maximum)


def env_bool(name, default):
    """Boolean env knob: 1/true/yes/on and 0/false/no/off (case-insensitive);
    absent/empty -> ``default``; anything else -> ``default`` with a single
    warning."""
    raw = os.getenv(name)
    if raw is None or raw == "":
        return default
    lowered = raw.strip().lower()
    if lowered in _TRUTHY:
        return True
    if lowered in _FALSY:
        return False
    _warn_once(name, raw, "a boolean ({}/{})".format("|".join(_TRUTHY), "|".join(_FALSY)), default)
    return default
