"""Deterministic fault injection for failure drills.

A failure path (a wedged predict dispatch, a slow decode, a drain that
cannot finish, a stalled round, a transient read error, NaN gradients)
cannot be produced on demand from real hardware. Each
such spot in the code is a named **fault point**: the code calls
``fault_point("serving.decode", ...)`` where the real world could
misbehave, and the ``SM_FAULT_SPEC`` env var (or ``configure()`` in tests)
arms a deterministic misbehaviour there. The grammar and the point names
are the JAX package's, so one spec drills either package.

Spec grammar (entries separated by ``;`` or ``,``)::

    SM_FAULT_SPEC = "<point>:<action>[:<param>][@<n>|@<n>+] [; ...]"

    serving.decode:error:bad      every payload decode fails (415)
    predict.dispatch:sleep:5      the request-thread predict stage stalls
                                  (deadline and drain drills); serving.encode
                                  is its twin on the response side
    batcher.dispatch:sleep:120@2  wedges the 2nd batched dispatch inside the
                                  batcher (the stuck-predict watchdog drill)
    model.load:error@3+           the 3rd model load and every later one fail
    data.read:error@1             the first channel file read fails once
                                  (the reader's retry absorbs it)
    checkpoint.save:error@2       the 2nd checkpoint write fails once;
                                  checkpoint.manifest is its sidecar's twin
    training.round_end:sleep:60@4 the 4th round stalls (the watchdog drill)
    train.gradient_poison:nan@3   the 3rd round's margins turn NaN before its
                                  gradients (the numeric-poison drill)

Actions: ``error[:msg]`` -> OSError, ``drop`` -> ConnectionError,
``sleep:<seconds>``, ``sigterm`` (SIGTERM to this process), ``exit:<code>``
(``os._exit``, no cleanup), ``kill`` (SIGKILL to this process), ``nan`` (no
raise: ``fault_point`` returns truthy and the call site poisons its own
data).

With ``SM_FAULT_SPEC`` unset the module global stays ``None`` and
``fault_point`` is one attribute read. A malformed entry is skipped with a
warning, so a drill with a typo still injects its valid entries.
"""

import logging
import os
import signal
import threading
import time

logger = logging.getLogger(__name__)

FAULT_SPEC_ENV = "SM_FAULT_SPEC"

_ACTIONS = ("error", "drop", "sleep", "sigterm", "exit", "kill", "nan")

# None = inert (the common case); else {point: [_Rule, ...]}
_ACTIVE = None


class _Rule:
    """One armed fault: an action bound to a point with a hit window."""

    def __init__(self, point, action, param=None, start=1, only=None):
        self.point = point
        self.action = action
        self.param = param
        self.start = start  # first hit (1-based) the rule fires on
        self.only = only    # fire on exactly this hit, or None for start+
        self.hits = 0
        self.fired = 0
        self._lock = threading.Lock()

    def fire(self, ctx):
        with self._lock:
            self.hits += 1
            hit = self.hits
        if self.only is not None:
            if hit != self.only:
                return None
        elif hit < self.start:
            return None
        with self._lock:
            self.fired += 1
        logger.warning(
            "fault injected at %r (hit %d): %s%s ctx=%r",
            self.point, hit, self.action,
            ":{}".format(self.param) if self.param is not None else "", ctx,
        )
        if self.action == "error":
            raise OSError(self.param or "fault-injected IO error at {}".format(self.point))
        if self.action == "drop":
            raise ConnectionError(
                self.param or "fault-injected connection drop at {}".format(self.point))
        if self.action == "sleep":
            time.sleep(float(self.param))
            return None
        if self.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            # give the handler a beat to run before the caller proceeds
            time.sleep(float(self.param) if self.param else 5.0)
            return None
        if self.action == "exit":
            os._exit(int(self.param) if self.param else 1)
        if self.action == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if self.action == "nan":
            return True
        return None


def _parse_entry(entry):
    """``point:action[:param][@n[+]]`` -> _Rule (raises ValueError)."""
    entry = entry.strip()
    if not entry:
        return None
    spec, start, only = entry, 1, None
    if "@" in entry:
        spec, _, trigger = entry.rpartition("@")
        trigger = trigger.strip()
        if trigger.endswith("+"):
            start = int(trigger[:-1])
        else:
            only = int(trigger)
        if (only is not None and only < 1) or start < 1:
            raise ValueError("hit trigger must be >= 1")
    parts = spec.split(":", 2)
    if len(parts) < 2:
        raise ValueError("expected <point>:<action>")
    point, action = parts[0].strip(), parts[1].strip()
    param = parts[2].strip() if len(parts) == 3 else None
    if not point or action not in _ACTIONS:
        raise ValueError("unknown action {!r} (one of {})".format(action, _ACTIONS))
    if action == "sleep":
        float(param)  # validate now, not when it fires
    if action == "exit" and param is not None:
        int(param)
    return _Rule(point, action, param=param, start=start, only=only)


def configure(spec):
    """(Re)arm from a spec string; ``None`` or empty disarms. Returns the
    armed rules by point, or None."""
    global _ACTIVE
    if not spec or not spec.strip():
        _ACTIVE = None
        return None
    rules = {}
    for raw in spec.replace(";", ",").split(","):
        try:
            rule = _parse_entry(raw)
        except (ValueError, TypeError) as e:
            logger.warning("ignoring malformed %s entry %r: %s", FAULT_SPEC_ENV, raw, e)
            continue
        if rule is not None:
            rules.setdefault(rule.point, []).append(rule)
    _ACTIVE = rules or None
    if _ACTIVE:
        logger.warning("fault injection ARMED at %d point(s): %s",
                       len(_ACTIVE), ", ".join(sorted(_ACTIVE)))
    return _ACTIVE


def configure_from_env():
    """Arm from ``SM_FAULT_SPEC`` (called once at import; tests re-call)."""
    return configure(os.getenv(FAULT_SPEC_ENV))


def reset():
    """Disarm every fault (test teardown)."""
    global _ACTIVE
    _ACTIVE = None


def fault_counts():
    """-> {point: fires} for the armed points."""
    active = _ACTIVE
    if not active:
        return {}
    return {point: sum(r.fired for r in rules) for point, rules in active.items()}


def fault_point(name, **ctx):
    """A named fault point: one global read unless armed. Returns truthy
    when a ``nan`` rule fired; every other action raises or returns None."""
    active = _ACTIVE
    if active is None:
        return None
    rules = active.get(name)
    if not rules:
        return None
    fired = False
    for rule in rules:
        if rule.fire(ctx):
            fired = True
    return fired or None


configure_from_env()
