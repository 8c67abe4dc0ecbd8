"""Process-wide metrics registry: counters, gauges, bounded-bucket histograms.

The in-process source both export surfaces read: the Prometheus text of
``GET /metrics`` (``prometheus.py``) and the structured stdout records
(``emit.py``). Stdlib only and thread-safe: request threads, batcher
workers and the reporter thread all touch it. Histograms keep fixed bucket
counts, not samples, so their memory does not grow with traffic.

Metric identity is ``(name, sorted(labels))``: get-or-create calls from
different sites return the same instance. Names, label sets and buckets are
the JAX package's, so a scrape config written for one endpoint reads the
other.
"""

import bisect
import math
import threading

# latency-shaped default buckets, in seconds: 1ms .. 10s + the implicit +Inf
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# size-shaped buckets (rows, requests per batch): powers of two
POW2_BUCKETS = tuple(float(2 ** i) for i in range(0, 15))


def percentile(values, q):
    """Exact linear-interpolation percentile of an unsorted list (q in 0..1)."""
    if not values:
        return float("nan")
    if not 0.0 <= q <= 1.0:
        raise ValueError("quantile must be in [0, 1]")
    ordered = sorted(values)
    pos = (len(ordered) - 1) * q
    lo = math.floor(pos)
    hi = math.ceil(pos)
    if lo == hi:
        return ordered[lo]
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def _label_key(labels):
    return tuple(sorted((labels or {}).items()))


class _Metric:
    __slots__ = ("name", "labels", "_lock")

    def __init__(self, name, labels):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"
    __slots__ = ("_value",)

    def __init__(self, name, labels=None):
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up (got %r)" % amount)
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(_Metric):
    kind = "gauge"
    __slots__ = ("_value",)

    def __init__(self, name, labels=None):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Fixed upper-bound buckets plus sum and count; quantiles are
    interpolated from the cumulative bucket counts (Prometheus
    ``histogram_quantile`` semantics, bounded by bucket resolution)."""

    kind = "histogram"
    __slots__ = ("bounds", "_counts", "_sum", "_count")

    def __init__(self, name, labels=None, buckets=None):
        super().__init__(name, labels)
        bounds = tuple(sorted(set(float(b) for b in (buckets or DEFAULT_BUCKETS))))
        if not bounds:
            raise ValueError("histogram needs at least one finite bucket bound")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot is +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        value = float(value)
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def snapshot(self):
        """-> (cumulative bucket counts aligned to bounds + [+Inf], sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cumulative = []
        running = 0
        for c in counts:
            running += c
            cumulative.append(running)
        return cumulative, s, total

    def quantile(self, q):
        """Estimate the q-quantile by linear interpolation inside the bucket
        holding it; observations past the last finite bound clamp to it."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return float("nan")
        target = q * total
        cum = 0.0
        lower = 0.0
        for bound, cnt in zip(self.bounds, counts):
            if cnt and cum + cnt >= target:
                return lower + (bound - lower) * ((target - cum) / cnt)
            cum += cnt
            lower = bound
        return self.bounds[-1]


class MetricsRegistry:
    """Thread-safe get-or-create registry; the process-wide instance is
    ``REGISTRY``. Tests build private ones."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.RLock()
        self._families = {}  # name -> (kind, help)
        self._metrics = {}  # (name, label_key) -> metric

    def _get_or_create(self, kind, name, help_text, labels, **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            family = self._families.get(name)
            if family is not None and family[0] != kind:
                raise ValueError("metric {!r} already registered as {} (requested {})".format(
                    name, family[0], kind))
            metric = self._metrics.get(key)
            if metric is None:
                metric = self._KINDS[kind](name, labels=labels, **kwargs)
                self._metrics[key] = metric
                if family is None:
                    self._families[name] = (kind, help_text or "")
            return metric

    def counter(self, name, help="", labels=None):
        return self._get_or_create("counter", name, help, labels)

    def gauge(self, name, help="", labels=None):
        return self._get_or_create("gauge", name, help, labels)

    def histogram(self, name, help="", labels=None, buckets=None):
        return self._get_or_create("histogram", name, help, labels, buckets=buckets)

    def collect(self):
        """-> [(name, kind, help, [metric, ...])] sorted by name, each
        family's series sorted by label key (a stable exposition)."""
        with self._lock:
            families = dict(self._families)
            by_name = {}
            for (name, lk), metric in self._metrics.items():
                by_name.setdefault(name, []).append((lk, metric))
        out = []
        for name in sorted(by_name):
            kind, help_text = families[name]
            series = [m for _lk, m in sorted(by_name[name], key=lambda p: p[0])]
            out.append((name, kind, help_text, series))
        return out

    def remove_matching(self, label_name, label_value):
        """Drop every series whose labels carry ``label_name == label_value``
        (an unloaded MME model's batcher series), so model churn cannot grow
        the registry without bound. Returns the number of series removed."""
        with self._lock:
            doomed = [key for key, metric in self._metrics.items()
                      if metric.labels.get(label_name) == label_value]
            for key in doomed:
                del self._metrics[key]
            return len(doomed)

    def reset(self):
        """Drop every metric (test isolation only, never while serving)."""
        with self._lock:
            self._families.clear()
            self._metrics.clear()


REGISTRY = MetricsRegistry()
