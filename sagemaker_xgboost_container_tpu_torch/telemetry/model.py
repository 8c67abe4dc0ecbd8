"""Model-quality plane (``SM_MODEL_TELEMETRY``): what the booster is
learning, whether its numbers are healthy, and whether serving traffic is
still the training distribution.

The port's counterpart of the JAX package's ``telemetry/model.py``. All of
it is env-gated: zero records, gauges and threads while
``SM_MODEL_TELEMETRY`` is unset, and the statistics are read-only
reductions, so the committed trees are bit-identical either way.

* **Per-round learning statistics**: the gbtree round computes one small
  f32 vector (gradient and hessian sums and extrema, NaN/Inf counts in the
  gradients and the margins; layout ``DEVICE_STAT_FIELDS``) with torch
  reductions and brings it to the host in the round's one device-to-host
  copy. The host folds in the committed trees' statistics
  (:func:`tree_stats`) and calls :func:`note_learning`: one
  ``training.learning`` record and gauges a round, and a bounded history.
* **Numeric-health guard**: a nonzero NaN/Inf count names the first
  poisoned round; the booster dumps :func:`dump_learning_forensics`
  (``learning-forensics-rank<r>.json``) and aborts with exit 87
  (``EXIT_NUMERIC_POISON``). The dump is robustness, not telemetry: it runs
  whenever the guard trips.
* **Learning curve**: ``EvaluationMonitor`` feeds every printed entry
  through :func:`note_eval`; :func:`learning_summary` is stamped into the
  model manifest.
* **Serving drift**: training captures per-feature bin-occupancy baselines
  from the binned matrix (:func:`baseline_from_binned`, stamped into the
  manifest); serving keeps a rolling window of feature and prediction
  histograms (:class:`DriftWindow`), computes PSI against the baseline,
  publishes ``model_drift_psi`` and ``serving.drift`` records, and quacks
  like a circuit breaker (``.degraded``), so the serving lifecycle folds
  sustained drift above ``SM_DRIFT_PSI_MAX`` into its DEGRADED state; it
  recovers once the shifted traffic ages out of ``SM_DRIFT_WINDOW_S``.

The defaults (PSI 0.2, a 300 s window, 200 rows, 10 groups, 64 rounds of
history, 10 prediction bins) are the JAX package's: statistics, not
hardware figures.
"""

import collections
import json
import logging
import math
import os
import threading
import time

import numpy as np

from ..constants import XGB_MAXIMIZE_METRICS
from ..utils.envconfig import env_bool, env_float, env_int
from .emit import emit_metric
from .registry import REGISTRY

logger = logging.getLogger(__name__)

#: master gate: unset ⇒ no records, no gauges, no drift window
MODEL_TELEMETRY_ENV = "SM_MODEL_TELEMETRY"
#: sustained per-feature PSI above this flips the drift window degraded
DRIFT_PSI_MAX_ENV = "SM_DRIFT_PSI_MAX"
#: rolling drift-window length in seconds
DRIFT_WINDOW_ENV = "SM_DRIFT_WINDOW_S"
#: rows the window must hold before it may degrade (cold-start guard)
DRIFT_MIN_ROWS_ENV = "SM_DRIFT_MIN_ROWS"

#: the industry-standard "significant shift" PSI threshold
DEFAULT_DRIFT_PSI_MAX = 0.2
DEFAULT_DRIFT_WINDOW_S = 300.0
#: sized so sampling noise can't reach the PSI threshold: with ~PSI_GROUPS
#: comparison groups, E[PSI] of in-distribution traffic ≈ (groups-1)/rows
DEFAULT_DRIFT_MIN_ROWS = 200

#: PSI comparison resolution: baseline bins are folded into this many
#: groups of roughly equal training mass (the standard ~decile PSI layout).
#: At full max_bin resolution a small window has near-empty bins whose eps
#: floors dominate the sum — deciles keep the statistic about the
#: distribution, not the sample size.
PSI_GROUPS = 10

#: rounds of stats kept for the forensics dump and /status
HISTORY_LEN = 64

#: prediction-histogram resolution (window-local edges, first batch sets them)
PRED_BINS = 10

#: layout of the per-round stats vector the booster computes on the device
#: (``models/booster.learning_stats``), in this order, as float32; the host
#: decodes by zipping. Counts ride as floats (an f32 exactly holds counts < 2^24).
DEVICE_STAT_FIELDS = (
    "grad_sum",
    "grad_min",
    "grad_max",
    "hess_sum",
    "hess_min",
    "hess_max",
    "grad_nonfinite",
    "margin_nonfinite",
)

_state_lock = threading.Lock()
_history = collections.deque(maxlen=HISTORY_LEN)  # per-round stats dicts
_last_stats = None
_eval_curve = collections.OrderedDict()  # (data, metric) -> [(round, value)]
_drift_baseline = None  # captured at training, stamped into the manifest


def enabled():
    return env_bool(MODEL_TELEMETRY_ENV, False)


def drift_psi_max():
    return env_float(DRIFT_PSI_MAX_ENV, DEFAULT_DRIFT_PSI_MAX, minimum=0.0)


def drift_window_s():
    return env_float(DRIFT_WINDOW_ENV, DEFAULT_DRIFT_WINDOW_S, minimum=1.0)


def drift_min_rows():
    return env_int(DRIFT_MIN_ROWS_ENV, DEFAULT_DRIFT_MIN_ROWS, minimum=1)


# --------------------------------------------------------- learning statistics
def decode_device_stats(vector):
    """One round's device stats vector -> field dict (zip with the layout)."""
    values = [float(v) for v in np.asarray(vector).reshape(-1)[: len(DEVICE_STAT_FIELDS)]]
    return dict(zip(DEVICE_STAT_FIELDS, values))


def tree_stats(trees):
    """Committed-tree statistics from one round's compact ``Tree`` objects
    (``models/forest.py``) — leaf-value/split-gain distributions, depth and
    leaf counts, summed across the round's trees. Never raises; unexpected
    shapes degrade to zeros."""
    out = {
        "trees": 0,
        "leaves": 0,
        "max_depth": 0,
        "leaf_value_min": 0.0,
        "leaf_value_max": 0.0,
        "leaf_value_absmax": 0.0,
        "split_gain_sum": 0.0,
        "split_gain_max": 0.0,
    }
    leaf_values = []
    gains = []
    try:
        for tree in trees:
            out["trees"] += 1
            leaf_mask = np.asarray(tree.is_leaf, dtype=bool)
            values = np.asarray(tree.value, dtype=np.float64)
            if values.size:
                leaf_values.append(values[leaf_mask[: values.size]])
            gain = np.asarray(tree.gain, dtype=np.float64)
            if gain.size:
                gains.append(gain[~leaf_mask[: gain.size]])
            out["leaves"] += int(leaf_mask.sum())
            out["max_depth"] = max(out["max_depth"], int(tree.depth()))
        if leaf_values:
            lv = np.concatenate(leaf_values) if len(leaf_values) > 1 else leaf_values[0]
            if lv.size:
                out["leaf_value_min"] = float(lv.min())
                out["leaf_value_max"] = float(lv.max())
                out["leaf_value_absmax"] = float(np.abs(lv).max())
        if gains:
            g = np.concatenate(gains) if len(gains) > 1 else gains[0]
            if g.size:
                out["split_gain_sum"] = float(g.sum())
                out["split_gain_max"] = float(g.max())
    except Exception as e:
        logger.debug("tree stats unavailable: %s", e)
    return out


def note_learning(round_index, stats, registry=None):
    """Fold one round's learning statistics into the plane: emit the
    ``training.learning`` record, set the gauges, append the history ring.
    The caller gates on :func:`enabled` — this function assumes the plane
    is armed. Returns the record."""
    record = {"round": int(round_index)}
    record.update({k: (round(v, 6) if isinstance(v, float) else v) for k, v in stats.items()})
    global _last_stats
    with _state_lock:
        _last_stats = record
        _history.append(record)
    reg = registry or REGISTRY
    reg.gauge(
        "model_grad_nonfinite",
        "NaN/Inf gradient entries observed in the last boosting round",
    ).set(record.get("grad_nonfinite", 0.0))
    reg.gauge(
        "model_leaf_value_absmax",
        "Largest |leaf value| committed in the last boosting round",
    ).set(record.get("leaf_value_absmax", 0.0))
    reg.gauge(
        "model_split_gain_max",
        "Largest split gain committed in the last boosting round",
    ).set(record.get("split_gain_max", 0.0))
    emit_metric("training.learning", **record)
    return record


def last_learning():
    with _state_lock:
        return dict(_last_stats) if _last_stats is not None else None


def learning_history():
    with _state_lock:
        return [dict(r) for r in _history]


def first_poisoned_round(stats_rows, first_round):
    """Scan decoded per-round stat dicts for the first round whose NaN/Inf
    counters are nonzero (or whose reductions themselves went nonfinite) —
    the numeric-health guard's trigger. Returns the absolute round index or
    None."""
    for offset, stats in enumerate(stats_rows):
        nonfinite = stats.get("grad_nonfinite", 0.0) + stats.get("margin_nonfinite", 0.0)
        reductions_bad = any(
            not math.isfinite(stats.get(field, 0.0))
            for field in ("grad_sum", "hess_sum", "grad_min", "grad_max")
        )
        if nonfinite > 0 or reductions_bad:
            return int(first_round) + offset
    return None


# --------------------------------------------------------------- eval curve
def _is_maximize(metric_name):
    base = metric_name.split("@", 1)[0]
    return base in XGB_MAXIMIZE_METRICS


def note_eval(round_index, data_name, metric_name, value):
    """One printed eval entry folded into the learning curve (called by
    EvaluationMonitor, gated on :func:`enabled` there). Keeps the full
    series per (dataset, metric) and refreshes the best-iteration gauge."""
    with _state_lock:
        series = _eval_curve.setdefault((data_name, metric_name), [])
        series.append((int(round_index), float(value)))
    summary = learning_summary()
    if summary and summary.get("best_iteration") is not None:
        REGISTRY.gauge(
            "model_best_iteration",
            "Round with the best score on the last eval dataset/metric",
        ).set(summary["best_iteration"])


def learning_summary():
    """The learning-curve summary for the manifest stamp and ``/status``:
    best iteration/score on the last (dataset, metric) pair (XGBoost
    semantics), final values for every pair, and the train/val gap trend
    of the last shared metric (a rising gap is the overfit early-warning).
    None when no eval entries have been folded."""
    with _state_lock:
        if not _eval_curve:
            return None
        curve = {k: list(v) for k, v in _eval_curve.items()}
    (last_data, last_metric), last_series = list(curve.items())[-1]
    maximize = _is_maximize(last_metric)
    best_round, best_value = last_series[0]
    for rnd, val in last_series:
        if (val > best_value) if maximize else (val < best_value):
            best_round, best_value = rnd, val
    summary = {
        "rounds": len(last_series),
        "dataset": last_data,
        "metric": last_metric,
        "best_iteration": best_round,
        "best_score": round(best_value, 6),
        "final": {
            "{}-{}".format(d, m): round(series[-1][1], 6)
            for (d, m), series in curve.items()
        },
    }
    datasets = {d for d, _m in curve}
    if len(datasets) > 1:
        # train/val gap on the last metric present under two datasets
        pair = [
            (d, curve[(d, last_metric)])
            for d in datasets
            if (d, last_metric) in curve
        ]
        if len(pair) >= 2:
            pair.sort(key=lambda item: item[0] != "train")  # train first
            train_series = dict(pair[0][1])
            val_series = dict(pair[1][1])
            gaps = [
                abs(val_series[r] - train_series[r])
                for r in sorted(set(train_series) & set(val_series))
            ]
            if gaps:
                summary["gap_last"] = round(gaps[-1], 6)
                window = gaps[-5:]
                summary["gap_trend"] = round(window[-1] - window[0], 6)
    return summary


def learning_status():
    """The ``learning`` section for ``/status`` and the SIGQUIT dump: the
    last per-round stats plus the curve summary. None when the plane is
    unarmed or nothing has been folded yet."""
    if not enabled():
        return None
    doc = {}
    last = last_learning()
    if last is not None:
        doc["last_round"] = last
    summary = learning_summary()
    if summary is not None:
        doc["curve"] = summary
    return doc or None


# ------------------------------------------------------------- drift baseline
def bin_features(features, cuts_per_feature):
    """Bin a raw (rows, features) float array against per-feature cut
    points, mirroring the training-side binner exactly: bin b holds values
    v where ``v < cut[i]`` iff ``b <= i`` — i.e. ``searchsorted(cuts, v,
    side="right")``. Non-finite entries (missing values) land in the final
    missing bucket. Returns per-feature count arrays of length
    ``len(cuts) + 2`` (real bins ``0..len(cuts)`` plus missing)."""
    matrix = np.asarray(features, dtype=np.float64)
    if matrix.ndim == 1:
        matrix = matrix.reshape(1, -1)
    counts = []
    for j, cuts in enumerate(cuts_per_feature):
        edges = np.asarray(cuts, dtype=np.float64)
        vec = np.zeros(edges.size + 2, dtype=np.int64)
        if j < matrix.shape[1]:
            col = matrix[:, j]
            finite_mask = np.isfinite(col)
            bins = np.searchsorted(edges, col[finite_mask], side="right")
            vec[: edges.size + 1] = np.bincount(bins, minlength=edges.size + 1)
            vec[-1] = int((~finite_mask).sum())
        counts.append(vec)
    return counts


def _bin_counts(bins, minlength):
    """Per-feature bin counts [d, >= minlength] of an [n, d] bin matrix: a
    numpy array, or a torch tensor counted where it lives (one bincount a
    feature, one copy of the counts to the host)."""
    if isinstance(bins, np.ndarray):
        return [np.bincount(bins[:, j].astype(np.int64), minlength=minlength)
                for j in range(bins.shape[1])]
    import torch

    def column(j):
        col = bins[:, j]
        if col.dtype == torch.uint16:  # few torch ops take uint16: widen via int16
            return col.view(torch.int16).long() & 0xFFFF
        return col.long()

    if not bins.shape[1]:
        return []
    # bins never pass the missing bin, so every count has minlength entries
    counts = torch.stack([torch.bincount(column(j), minlength=minlength)
                          for j in range(bins.shape[1])])
    return list(counts.cpu().numpy())


def baseline_from_binned(binned):
    """Per-feature bin-occupancy baseline from the training ``BinnedMatrix``
    (bins a numpy array or a tensor on the card): one ``bincount`` a
    feature. Missing values (the shared bin at index ``max_bin``) fold into
    a final missing bucket so the layout matches :func:`bin_features`
    (length ``len(cuts) + 2``). Returns the manifest-shaped dict: the cut
    points travel with the fractions so serving can bin raw request
    features the same way."""
    bins = binned.bins
    rows = int(bins.shape[0])
    missing_bin = int(binned.max_bin)
    features = []
    for j, full in enumerate(_bin_counts(bins, missing_bin + 1)):
        cuts = [float(c) for c in np.asarray(binned.cut_points[j]).reshape(-1)]
        vec = np.zeros(len(cuts) + 2, dtype=np.int64)
        real = min(len(cuts) + 1, full.size)
        vec[:real] = full[:real]
        if full.size > missing_bin:
            vec[-1] = int(full[missing_bin])
        total = max(int(vec.sum()), 1)
        features.append(
            {
                "cuts": cuts,
                "fracs": [round(float(c) / total, 6) for c in vec],
            }
        )
    return {"version": 1, "rows": rows, "features": features}


def capture_drift_baseline(binned):
    """Capture the training-distribution baseline (called by the booster
    session when the plane is armed); :func:`drift_baseline` hands it to
    the manifest writer at model-save time. Never raises."""
    global _drift_baseline
    try:
        baseline = baseline_from_binned(binned)
    except Exception as e:
        logger.warning("drift baseline capture failed: %s", e)
        return None
    with _state_lock:
        _drift_baseline = baseline
    return baseline


def drift_baseline():
    with _state_lock:
        return _drift_baseline


def psi_groups(expected, max_groups=PSI_GROUPS):
    """Map fine histogram bins onto at most ``max_groups`` contiguous
    groups of roughly equal expected mass — PSI's standard decile layout.
    The manifest keeps full max_bin resolution; only the comparison is
    coarsened. Returns an int group index per bin."""
    expected = np.asarray(expected, dtype=np.float64)
    groups = np.zeros(expected.size, dtype=np.int64)
    target = 1.0 / max_groups
    acc, g = 0.0, 0
    for i, frac in enumerate(expected):
        groups[i] = g
        acc += float(frac)
        if acc >= target and g < max_groups - 1 and i < expected.size - 1:
            acc, g = 0.0, g + 1
    return groups


def psi(expected_fracs, actual_counts, eps=1e-4):
    """Population stability index of an observed bin-count vector against
    baseline fractions: ``sum((a - e) * ln(a / e))`` with both sides
    floored at ``eps`` so empty bins don't blow up the sum."""
    expected = np.maximum(np.asarray(expected_fracs, dtype=np.float64), eps)
    counts = np.asarray(actual_counts, dtype=np.float64)
    total = counts.sum()
    if total <= 0:
        return 0.0
    actual = np.maximum(counts / total, eps)
    n = min(expected.size, actual.size)
    e, a = expected[:n], actual[:n]
    return float(np.sum((a - e) * np.log(a / e)))


class DriftWindow:
    """Rolling feature/prediction-distribution window vs the training
    baseline, shaped like the SLO window: ``observe`` accumulates, reads
    trim expired batches (automatic recovery), ``.degraded`` is the
    breaker-shaped hook the serving lifecycle folds into its derived
    state. ``clock`` is injectable so drills need not sleep."""

    def __init__(self, baseline, psi_max=None, window_s=None, min_rows=None,
                 registry=None, clock=None):
        self.baseline = baseline
        self.psi_max = float(psi_max if psi_max is not None else drift_psi_max())
        self.window_s = float(window_s if window_s is not None else drift_window_s())
        self.min_rows = int(min_rows if min_rows is not None else drift_min_rows())
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._batches = collections.deque()  # (t, rows, counts list, pred hist)
        self._expected = [
            np.asarray(f["fracs"], dtype=np.float64) for f in baseline["features"]
        ]
        # the cuts as arrays once: a request's binning must not convert
        # max_bin floats a feature (the serving hot path)
        self._cuts = [np.asarray(f["cuts"], dtype=np.float64) for f in baseline["features"]]
        self._totals = [np.zeros(e.size, dtype=np.int64) for e in self._expected]
        # PSI is compared on decile-style groups, not raw max_bin bins: a
        # small window leaves fine bins empty and their eps floors would
        # dominate the sum (sample-size artifact, not drift)
        self._groups = [psi_groups(e) for e in self._expected]
        # the baseline side of each comparison is constant: group it once
        self._n_groups = [int(g[-1]) + 1 if g.size else 1 for g in self._groups]
        self._e_grouped = [np.bincount(g, weights=e, minlength=n) for g, e, n in
                           zip(self._groups, self._expected, self._n_groups)]
        self._rows = 0
        self._pred_edges = None
        self._pred_total = np.zeros(PRED_BINS, dtype=np.int64)
        self._degraded = False
        reg = registry or REGISTRY
        # created (at zero) on install so the series exists from the first
        # scrape, not the first drifted window
        self._m_psi = reg.gauge(
            "model_drift_psi",
            "Worst per-feature PSI of the serving window vs the training baseline",
        )
        self._m_psi.set(0.0)

    # ------------------------------------------------------------- feed path
    def observe(self, features, predictions=None):
        """Fold one request's raw feature matrix (and optionally its
        predictions) into the window; refresh the PSI gauge and emit a
        ``serving.drift`` record on every degraded/recovered transition."""
        matrix = np.asarray(features)
        rows = int(matrix.shape[0]) if matrix.ndim >= 2 else 1
        counts = bin_features(matrix, self._cuts)
        pred_hist = None
        if predictions is not None:
            pred_hist = self._pred_histogram(predictions)
        now = self._clock()
        with self._lock:
            self._batches.append((now, rows, counts, pred_hist))
            for total, c in zip(self._totals, counts):
                total += c[: total.size]
            self._rows += rows
            if pred_hist is not None:
                self._pred_total += pred_hist
            self._trim_locked(now)
            worst, worst_feature, _ = self._psi_locked()
            degraded = self._rows >= self.min_rows and worst > self.psi_max
            transition = degraded != self._degraded
            self._degraded = degraded
            rows_now = self._rows
        self._m_psi.set(round(worst, 4))
        if transition:
            emit_metric(
                "serving.drift",
                drifted=degraded,
                psi=round(worst, 4),
                psi_max=self.psi_max,
                feature=worst_feature,
                rows=rows_now,
                window_s=self.window_s,
            )
        return worst

    def _pred_histogram(self, predictions):
        preds = np.asarray(predictions, dtype=np.float64).reshape(-1)
        preds = preds[np.isfinite(preds)]
        if preds.size == 0:
            return None
        if self._pred_edges is None:
            lo, hi = float(preds.min()), float(preds.max())
            if 0.0 <= lo and hi <= 1.0:
                lo, hi = 0.0, 1.0  # probability outputs: stable edges
            elif hi <= lo:
                hi = lo + 1.0
            self._pred_edges = np.linspace(lo, hi, PRED_BINS + 1)
        hist, _ = np.histogram(preds, bins=self._pred_edges)
        return hist.astype(np.int64)

    def _trim_locked(self, now):
        cutoff = now - self.window_s
        while self._batches and self._batches[0][0] < cutoff:
            _t, rows, counts, pred_hist = self._batches.popleft()
            for total, c in zip(self._totals, counts):
                total -= c[: total.size]
            self._rows -= rows
            if pred_hist is not None:
                self._pred_total -= pred_hist

    def _psi_locked(self):
        worst, worst_feature = 0.0, -1
        per_feature = []
        for j, (e_grouped, counts, groups, n_groups) in enumerate(
            zip(self._e_grouped, self._totals, self._groups, self._n_groups)
        ):
            a_grouped = np.bincount(
                groups, weights=counts.astype(np.float64), minlength=n_groups
            )
            value = psi(e_grouped, a_grouped)
            per_feature.append(value)
            if value > worst:
                worst, worst_feature = value, j
        return worst, worst_feature, per_feature

    # ------------------------------------------------------------ read paths
    @property
    def degraded(self):
        """Breaker-shaped hook for the serving lifecycle: True while the
        window holds enough rows and the worst per-feature PSI exceeds
        ``SM_DRIFT_PSI_MAX``. Trims first, so recovery is automatic once
        the shifted traffic ages out."""
        with self._lock:
            self._trim_locked(self._clock())
            worst, _, _ = self._psi_locked()
            return self._rows >= self.min_rows and worst > self.psi_max

    def snapshot(self):
        """-> the ``drift`` section for ``/status``: threshold, window,
        rows, worst/per-feature PSI, prediction histogram, degraded."""
        with self._lock:
            self._trim_locked(self._clock())
            worst, worst_feature, per_feature_raw = self._psi_locked()
            per_feature = [round(v, 4) for v in per_feature_raw]
            rows = self._rows
            pred = None
            total = int(self._pred_total.sum())
            if self._pred_edges is not None and total > 0:
                pred = {
                    "edges": [round(float(e), 6) for e in self._pred_edges],
                    "fracs": [
                        round(float(c) / total, 4) for c in self._pred_total
                    ],
                }
        doc = {
            "psi_max": self.psi_max,
            "window_s": self.window_s,
            "rows": rows,
            "psi": round(worst, 4),
            "worst_feature": worst_feature,
            "per_feature_psi": per_feature,
            "degraded": rows >= self.min_rows and worst > self.psi_max,
        }
        if pred is not None:
            doc["prediction"] = pred
        return doc


# ------------------------------------------------------------- process plane
_drift_lock = threading.Lock()
_drift = None


def maybe_install_drift(baseline, registry=None):
    """Arm the process-wide drift window from a manifest baseline when the
    plane is enabled. Called by serve_utils at model-load time; idempotent
    (the first loaded baseline wins — MME models share one window per
    process, like the SLO window). Returns the window or None."""
    global _drift
    if _drift is not None:
        return _drift
    if not enabled() or not baseline or not baseline.get("features"):
        return None
    with _drift_lock:
        if _drift is None:
            _drift = DriftWindow(baseline, registry=registry)
            logger.info(
                "serving drift monitor armed: %d features, PSI max %.3f over a %.0fs window",
                len(baseline["features"]),
                _drift.psi_max,
                _drift.window_s,
            )
    return _drift


def active_drift():
    """The installed drift window, or None when the plane is disarmed."""
    return _drift


def drift_status():
    """The ``drift`` section for ``/status`` (None when disarmed)."""
    window = _drift
    return window.snapshot() if window is not None else None


# ------------------------------------------------------- learning forensics
def dump_learning_forensics(reason, first_bad_round=None, default_dir=None):
    """Write ``learning-forensics-rank<r>.json`` when the numeric-health
    guard trips: the last-K per-round stats history, the first poisoned
    round, and the eval curve so far. Robustness path — runs regardless of
    ``SM_MODEL_TELEMETRY`` once the guard has stats in hand (a poisoned
    job's last act should always name the round that went bad). Never
    raises; returns the path or None."""
    try:
        from . import tracing
        from .device import _forensics_dir

        rank = tracing.get_rank()
        doc = {
            "reason": reason,
            "rank": rank,
            "stats_history": learning_history(),
        }
        if first_bad_round is not None:
            doc["first_bad_round"] = int(first_bad_round)
        summary = learning_summary()
        if summary is not None:
            doc["curve"] = summary
        directory = _forensics_dir(default_dir)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "learning-forensics-rank{}.json".format(rank))
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
            f.write("\n")
        logger.error(
            "numeric poison: learning forensics (last %d rounds of stats) dumped to %s",
            len(doc["stats_history"]), path,
        )
        return path
    except Exception:
        logger.exception("learning forensics dump failed; aborting anyway")
        return None


def _reset_for_tests():
    global _last_stats, _drift_baseline, _drift
    with _state_lock:
        _last_stats = None
        _history.clear()
        _eval_curve.clear()
        _drift_baseline = None
    with _drift_lock:
        _drift = None
