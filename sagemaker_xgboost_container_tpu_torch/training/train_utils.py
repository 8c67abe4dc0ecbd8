"""Metric-list plumbing between the HPO config and the native metrics.

The union of the HPO tuning metric and the user's eval_metric is sorted so
that every host agrees on its order. The JAX package splits custom
(sklearn) metrics off into a ``feval``; the port computes none of them yet,
so a custom metric name raises ``UserError`` naming it.
"""

import os

from ..toolkit import exceptions as exc

HPO_SEPARATOR = ":"

# the metrics the JAX package computes with sklearn as a feval
# (sagemaker_xgboost_container_tpu/metrics/custom_metrics.py)
CUSTOM_METRICS = (
    "accuracy",
    "balanced_accuracy",
    "f1",
    "f1_binary",
    "f1_macro",
    "mse",
    "precision",
    "precision_macro",
    "precision_micro",
    "r2",
    "recall",
    "recall_macro",
    "recall_micro",
)


class MetricNameComponents:
    """Decodes ``validation:auc[:freq]`` tuning-objective names."""

    def __init__(self, data_segment, metric_name, emission_frequency=None):
        self.data_segment = data_segment
        self.metric_name = metric_name
        self.emission_frequency = emission_frequency

    @classmethod
    def decode(cls, tuning_objective_metric):
        return cls(*tuning_objective_metric.split(HPO_SEPARATOR))


def get_union_metrics(metric_a, metric_b):
    """Sorted union (order must agree across hosts)."""
    if metric_a is None and metric_b is None:
        return None
    if metric_a is None:
        return metric_b
    if metric_b is None:
        return metric_a
    return sorted(set(metric_a) | set(metric_b))


def get_custom_metrics(eval_metrics):
    """The names in ``eval_metrics`` that only a feval computes."""
    return [m for m in eval_metrics if m in CUSTOM_METRICS]


def get_eval_metrics_and_feval(tuning_objective_metric_param, eval_metric):
    """-> (native metric list, feval (always None), tuning metric list)."""
    tuning_objective_metric = None
    cleaned_eval_metrics = None

    if tuning_objective_metric_param is not None:
        components = MetricNameComponents.decode(tuning_objective_metric_param)
        tuning_objective_metric = components.metric_name.split(",")

    union = get_union_metrics(tuning_objective_metric, eval_metric)
    if union is not None:
        custom = get_custom_metrics(union)
        if custom:
            raise exc.UserError(
                "custom metrics are not supported by the PyTorch port yet: {}".format(
                    ", ".join(custom)
                )
            )
        cleaned_eval_metrics = union

    return cleaned_eval_metrics, None, tuning_objective_metric


def cleanup_dir(directory, file_prefix):
    """Remove files in ``directory`` that don't start with ``file_prefix``."""
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if os.path.isfile(path) and not name.startswith(file_prefix):
            try:
                os.remove(path)
            except OSError:
                pass
