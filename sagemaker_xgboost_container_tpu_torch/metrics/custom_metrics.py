"""The "custom" metrics, computed by a feval during training.

The port's counterpart of ``sagemaker_xgboost_container_tpu/metrics/custom_metrics.py``,
which computes them with sklearn; here they are numpy, with sklearn's
definitions (the GPU machine has no sklearn). Metrics the booster does not
compute natively ride the feval channel and print in the same metric line as
the native ones, so the HPO regex covers them alike. As in xgboost >= 1.2
the feval receives the raw margin (log-odds for binary, [n, C] margins for
multiclass) and converts it to class labels itself.

Order matters for distributed training: the configured metric list keeps
the order given; callers pass a sorted union (``training/train_utils``).
"""

import numpy as np

from ..constants import MULTI_CLASS_F1_BINARY_ERROR
from ..toolkit import exceptions as exc

_BINARY_AVERAGE_ERROR = (MULTI_CLASS_F1_BINARY_ERROR + ". Please choose another average "
                         "setting, one of [None, 'micro', 'macro', 'weighted'].")


def sigmoid(x):
    """Margin -> probability; tanh form is stable for large |x|."""
    return 0.5 * (1 + np.tanh(0.5 * x))


def margin_to_class_label(preds):
    """Raw margin -> class label (argmax for multiclass, >0 for binary)."""
    preds = np.asarray(preds)
    if preds.ndim > 1:
        return np.argmax(preds, axis=-1)
    return (preds > 0.0).astype(int)


def _ratio(num, den):
    """num / den, 0 where den is 0 (sklearn's zero_division default)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)


def _counts(y, p, labels):
    """Per label: true positives, predicted count, true count."""
    tp = np.array([np.sum((y == c) & (p == c)) for c in labels], np.float64)
    pred = np.array([np.sum(p == c) for c in labels], np.float64)
    true = np.array([np.sum(y == c) for c in labels], np.float64)
    return tp, pred, true


def _binary_counts(y, p):
    """(tp, predicted, true) of the positive label 1, after sklearn's
    checks for average='binary'."""
    present = np.unique(np.concatenate([y, p]))
    if len(present) > 2:
        raise ValueError(_BINARY_AVERAGE_ERROR)
    if len(present) == 2 and 1 not in present:
        raise ValueError("pos_label=1 is not a valid label. It should be one of {}".format(
            list(present)))
    return _counts(y, p, [1])


def accuracy(y, p):
    return float(np.mean(y == p)) if len(y) else 0.0


def balanced_accuracy(y, p):
    """Mean recall over the classes of the true labels."""
    tp, _pred, true = _counts(y, p, np.unique(y))
    return float(np.mean(tp / true))


def f1(y, p, average):
    if average == "binary":
        tp, pred, true = _binary_counts(y, p)
    else:
        tp, pred, true = _counts(y, p, np.unique(np.concatenate([y, p])))
    return float(np.mean(_ratio(2 * tp, pred + true)))


def precision(y, p, average):
    if average == "binary":
        tp, pred, _true = _binary_counts(y, p)
    elif average == "micro":
        return float(_ratio(np.sum(y == p), len(p)))
    else:
        tp, pred, _true = _counts(y, p, np.unique(np.concatenate([y, p])))
    return float(np.mean(_ratio(tp, pred)))


def recall(y, p, average):
    if average == "binary":
        tp, _pred, true = _binary_counts(y, p)
    elif average == "micro":
        return float(_ratio(np.sum(y == p), len(y)))
    else:
        tp, _pred, true = _counts(y, p, np.unique(np.concatenate([y, p])))
    return float(np.mean(_ratio(tp, true)))


def _regression_inputs(y, p):
    y, p = np.asarray(y), np.asarray(p)
    dtype = np.result_type(y.dtype, p.dtype, np.float32)
    return y.astype(dtype, copy=False), p.astype(dtype, copy=False)


def mse(y, p):
    y, p = _regression_inputs(y, p)
    return float(np.mean((y - p) ** 2))


def mae(y, p):
    y, p = _regression_inputs(y, p)
    return float(np.mean(np.abs(y - p)))


def r2(y, p):
    """1 - SS_res / SS_tot; 1 for a perfect fit of a constant target, else
    0 there (sklearn's force_finite)."""
    y, p = _regression_inputs(y, p)
    numerator = np.sum((y - p) ** 2)
    denominator = np.sum((y - np.mean(y)) ** 2)
    if denominator == 0:
        return 1.0 if numerator == 0 else 0.0
    return float(1 - numerator / denominator)


def _classification(metricfunc, check_binary=False):
    def compute(preds, dtrain):
        if np.asarray(preds).size == 0:
            return 0.0
        labels = dtrain.get_label()
        pred_labels = margin_to_class_label(preds)
        if check_binary and len(np.unique(labels)) > 2:
            raise exc.UserError(MULTI_CLASS_F1_BINARY_ERROR)
        return float(metricfunc(labels, pred_labels))

    return compute


def _regression(metricfunc):
    def compute(preds, dtrain):
        return float(metricfunc(dtrain.get_label(), np.asarray(preds)))

    return compute


CUSTOM_METRICS = {
    "accuracy": _classification(accuracy),
    "balanced_accuracy": _classification(balanced_accuracy),
    "f1": _classification(lambda y, p: f1(y, p, "macro")),
    "f1_binary": _classification(lambda y, p: f1(y, p, "binary"), check_binary=True),
    "f1_macro": _classification(lambda y, p: f1(y, p, "macro")),
    "mse": _regression(mse),
    "rmse": _regression(lambda y, p: float(np.sqrt(mse(y, p)))),
    "mae": _regression(mae),
    "precision": _classification(lambda y, p: precision(y, p, "binary")),
    "precision_macro": _classification(lambda y, p: precision(y, p, "macro")),
    "precision_micro": _classification(lambda y, p: precision(y, p, "micro")),
    "r2": _regression(r2),
    "recall": _classification(lambda y, p: recall(y, p, "binary")),
    "recall_macro": _classification(lambda y, p: recall(y, p, "macro")),
    "recall_micro": _classification(lambda y, p: recall(y, p, "micro")),
}


def get_custom_metrics(eval_metrics):
    """The requested metrics that a feval computes, in the order given."""
    return [m for m in eval_metrics if m in CUSTOM_METRICS]


def configure_feval(custom_metric_list):
    """The feval: (margin, dtrain) -> [(name, value), ...]."""

    def custom_feval(preds, dtrain):
        return [(name, CUSTOM_METRICS[name](preds, dtrain)) for name in custom_metric_list]

    return custom_feval
