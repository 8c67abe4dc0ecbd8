"""Evaluation metrics on the host (the xgboost ``eval_metric`` set).

Numpy versions evaluated on *transformed* predictions (probabilities for
logistic, class probabilities for the multiclass metrics), with the JAX
package's semantics. The booster evaluates a metric here only where it has
no device form (``device_metrics``): ``mphe``, ``aucpr``, ``aft-nloglik``,
``interval-regression-accuracy`` and the ranking metrics ``ndcg`` and
``map`` (with or without ``@k``), which take the query groups.

Each metric: fn(preds, labels, weights) -> float. ``preds`` is what
``Objective.margin_to_prediction`` returns except for the multiclass
metrics, which receive the full [n, C] probability matrix.
"""

import numpy as np

from ..toolkit import exceptions as exc

_EPS = 1e-15


def _w(weights, labels):
    return np.ones_like(labels) if weights is None else weights


def rmse(preds, labels, weights=None):
    w = _w(weights, labels)
    return float(np.sqrt(np.sum(w * (preds - labels) ** 2) / np.sum(w)))


def mse(preds, labels, weights=None):
    w = _w(weights, labels)
    return float(np.sum(w * (preds - labels) ** 2) / np.sum(w))


def mae(preds, labels, weights=None):
    w = _w(weights, labels)
    return float(np.sum(w * np.abs(preds - labels)) / np.sum(w))


def mape(preds, labels, weights=None):
    w = _w(weights, labels)
    rel = np.abs((labels - preds) / np.maximum(np.abs(labels), _EPS))
    return float(np.sum(w * rel) / np.sum(w))


def rmsle(preds, labels, weights=None):
    w = _w(weights, labels)
    sq = (np.log1p(np.maximum(preds, 0)) - np.log1p(labels)) ** 2
    return float(np.sqrt(np.sum(w * sq) / np.sum(w)))


def mphe(preds, labels, weights=None, slope=1.0):
    w = _w(weights, labels)
    z = (preds - labels) / slope
    return float(np.sum(w * (slope**2) * (np.sqrt(1 + z * z) - 1)) / np.sum(w))


def logloss(preds, labels, weights=None):
    w = _w(weights, labels)
    # float64 before clipping: in float32, 1 - 1e-15 rounds to exactly 1.0
    p = np.clip(np.asarray(preds, np.float64), _EPS, 1 - _EPS)
    return float(-np.sum(w * (labels * np.log(p) + (1 - labels) * np.log(1 - p))) / np.sum(w))


def error(preds, labels, weights=None, threshold=0.5):
    w = _w(weights, labels)
    pred_label = (preds > threshold).astype(np.float32)
    return float(np.sum(w * (pred_label != labels)) / np.sum(w))


def auc(preds, labels, weights=None):
    """Weighted ROC-AUC via the Mann-Whitney statistic with tie midranks in
    cumulative-weight space."""
    w = _w(weights, labels)
    pos = labels > 0
    if not pos.any() or pos.all():
        raise exc.UserError(
            "Check failed: !auc_error AUC: the dataset only contains pos or neg samples"
        )
    order = np.argsort(preds, kind="stable")
    sp, sw, spos = preds[order], w[order], pos[order]
    _, inv = np.unique(sp, return_inverse=True)
    group_w = np.bincount(inv, weights=sw)
    group_end = np.cumsum(group_w)
    ranks = (group_end - group_w / 2.0)[inv]
    w_pos = float(np.sum(sw[spos]))
    w_neg = float(np.sum(sw[~spos]))
    u = float(np.sum(ranks[spos] * sw[spos])) - w_pos * w_pos / 2.0
    return float(np.clip(u / (w_pos * w_neg), 0.0, 1.0))


def aucpr(preds, labels, weights=None):
    """Weighted average precision, sum over the distinct scores (highest
    first) of (recall step) x precision: the definition of sklearn's
    ``average_precision_score``, which the JAX package calls, in numpy."""
    w = np.asarray(_w(weights, labels), np.float64)
    pos = labels > 0
    order = np.argsort(preds, kind="mergesort")[::-1]
    score, pos, w = np.asarray(preds)[order], pos[order], w[order]
    # the last entry of each run of equal scores closes a threshold
    ends = np.r_[np.nonzero(np.diff(score))[0], len(score) - 1]
    tps = np.cumsum(w * pos)[ends]
    fps = np.cumsum(w * ~pos)[ends]
    if len(tps) == 0 or tps[-1] <= 0:
        return 0.0
    predicted = tps + fps
    precision = np.divide(tps, predicted, out=np.zeros_like(tps), where=predicted != 0)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def merror(prob_matrix, labels, weights=None):
    w = _w(weights, labels)
    pred_label = np.argmax(prob_matrix, axis=1)
    return float(np.sum(w * (pred_label != labels)) / np.sum(w))


def mlogloss(prob_matrix, labels, weights=None):
    w = _w(weights, labels)
    p = np.clip(
        np.asarray(prob_matrix, np.float64)[np.arange(len(labels)), labels.astype(int)],
        _EPS,
        1.0,
    )
    return float(-np.sum(w * np.log(p)) / np.sum(w))


def poisson_nloglik(preds, labels, weights=None):
    from scipy.special import gammaln

    w = _w(weights, labels)
    p = np.maximum(preds, _EPS)
    return float(np.sum(w * (p - labels * np.log(p) + gammaln(labels + 1))) / np.sum(w))


def gamma_nloglik(preds, labels, weights=None):
    w = _w(weights, labels)
    p = np.maximum(preds, _EPS)
    y = np.maximum(labels, _EPS)
    return float(np.sum(w * (np.log(p) + y / p)) / np.sum(w))


def gamma_deviance(preds, labels, weights=None):
    w = _w(weights, labels)
    p = np.maximum(preds, _EPS)
    y = np.maximum(labels, _EPS)
    return float(2.0 * np.sum(w * (np.log(p / y) + y / p - 1)) / np.sum(w))


def tweedie_nloglik(preds, labels, weights=None, rho=1.5):
    w = _w(weights, labels)
    p = np.maximum(preds, _EPS)
    a = labels * np.power(p, 1 - rho) / (1 - rho)
    b = np.power(p, 2 - rho) / (2 - rho)
    return float(np.sum(w * (-a + b)) / np.sum(w))


def aft_nloglik(preds, labels, weights=None, dist="normal", sigma=1.0):
    """AFT negative log-likelihood for uncensored (point-label) data; preds
    are event times (exp(margin)), z = (log y - log pred) / sigma."""
    w = _w(weights, labels)
    y = np.maximum(labels, 1e-12)
    z = (np.log(y) - np.log(np.maximum(preds, 1e-12))) / sigma
    if dist == "logistic":
        nll = -(-z - 2.0 * np.log1p(np.exp(-z))) + np.log(sigma * y)
    elif dist == "extreme":
        nll = -(z - np.exp(np.clip(z, -30, 30))) + np.log(sigma * y)
    else:  # normal
        nll = 0.5 * z * z + np.log(sigma * y * np.sqrt(2 * np.pi))
    return float(np.sum(w * nll) / np.sum(w))


def cox_nloglik(preds, labels, weights=None):
    """Negative Breslow partial log-likelihood; labels < 0 are censored at
    |t|, preds are hazard ratios exp(margin)."""
    w = _w(weights, labels)
    event = (labels > 0).astype(np.float64)
    order = np.argsort(-np.abs(labels), kind="stable")
    hz = np.maximum(np.asarray(preds, np.float64), 1e-300)[order] * w[order]
    cum_risk = np.cumsum(hz)
    ev = (event * w)[order]
    # weight-0 rows have hz = 0: clamp inside the log so 0 * log(0) is 0
    ll = np.sum(ev * (np.log(np.maximum(hz, 1e-300)) - np.log(np.maximum(cum_risk, 1e-300))))
    return float(-ll / max(ev.sum(), 1e-12))


def interval_regression_accuracy(preds, labels, weights=None):
    raise exc.UserError(
        "Metric 'interval-regression-accuracy' requires interval-censored labels "
        "(label_lower_bound/label_upper_bound), which the csv/libsvm data contract "
        "cannot express; use 'aft-nloglik' instead."
    )


def _dcg_at(scores_sorted_labels, k):
    gains = (2.0**scores_sorted_labels - 1.0) / np.log2(np.arange(2, len(scores_sorted_labels) + 2))
    if k:
        gains = gains[:k]
    return gains.sum()


def ndcg(preds, labels, weights=None, groups=None, k=None):
    """Mean NDCG over query groups (groups = group-size array; None is one
    group of all rows). A group without a relevant document scores 1."""
    if groups is None:
        groups = np.asarray([len(labels)])
    out, start = [], 0
    for size in groups:
        size = int(size)
        sl = slice(start, start + size)
        start += size
        lab = labels[sl]
        order = np.argsort(-preds[sl], kind="stable")
        dcg = _dcg_at(lab[order], k)
        ideal = _dcg_at(np.sort(lab)[::-1], k)
        out.append(dcg / ideal if ideal > 0 else 1.0)
    return float(np.mean(out))


def map_metric(preds, labels, weights=None, groups=None, k=None):
    """Mean average precision over query groups (binary relevance, label >
    0). A group without a relevant document scores 1."""
    if groups is None:
        groups = np.asarray([len(labels)])
    out, start = [], 0
    for size in groups:
        size = int(size)
        sl = slice(start, start + size)
        start += size
        lab = (labels[sl] > 0).astype(np.float64)
        order = np.argsort(-preds[sl], kind="stable")
        rel = lab[order]
        if k:
            rel = rel[:k]
        hits = np.cumsum(rel)
        precisions = hits / np.arange(1, len(rel) + 1)
        denom = rel.sum()
        out.append(float((precisions * rel).sum() / denom) if denom > 0 else 1.0)
    return float(np.mean(out))


_SIMPLE = {
    "rmse": rmse,
    "mse": mse,
    "mae": mae,
    "mape": mape,
    "rmsle": rmsle,
    "mphe": mphe,
    "logloss": logloss,
    "error": error,
    "auc": auc,
    "aucpr": aucpr,
    "poisson-nloglik": poisson_nloglik,
    "gamma-nloglik": gamma_nloglik,
    "gamma-deviance": gamma_deviance,
    "tweedie-nloglik": tweedie_nloglik,
    "aft-nloglik": aft_nloglik,
    "cox-nloglik": cox_nloglik,
    "interval-regression-accuracy": interval_regression_accuracy,
}

_MULTI = {"merror": merror, "mlogloss": mlogloss}
_RANKING = {"ndcg": ndcg, "map": map_metric}


def is_native_metric(name):
    base = name.split("@")[0]
    return base in _SIMPLE or base in _MULTI or base in _RANKING


def evaluate(name, preds, labels, weights=None, groups=None, prob_matrix=None):
    """Dispatch one metric by its (possibly @-suffixed) name; ``groups``
    (group sizes) are read by the ranking metrics only."""
    base, _, suffix = name.partition("@")
    if base in _MULTI:
        if prob_matrix is None:
            raise exc.AlgorithmError("metric {} needs the probability matrix".format(name))
        return _MULTI[base](prob_matrix, labels, weights)
    if base in _RANKING:
        k = int(float(suffix)) if suffix else None
        return _RANKING[base](preds, labels, weights, groups=groups, k=k)
    if base == "error" and suffix:
        return error(preds, labels, weights, threshold=float(suffix))
    if base == "tweedie-nloglik" and suffix:
        return tweedie_nloglik(preds, labels, weights, rho=float(suffix))
    if base in _SIMPLE:
        return _SIMPLE[base](preds, labels, weights)
    raise exc.UserError("Unknown eval metric: {}".format(name))
