"""Metric-list plumbing between the HPO config, the native metrics and the
feval.

The union of the HPO tuning metric and the user's eval_metric is sorted so
that every host agrees on its order, then split into the natively computed
metrics and the custom ones a feval computes (``metrics/custom_metrics``),
as the JAX package's ``train_utils`` splits them.
"""

import os

from ..metrics.custom_metrics import configure_feval, get_custom_metrics

HPO_SEPARATOR = ":"


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


def get_eval_metrics_and_feval(tuning_objective_metric_param, eval_metric):
    """-> (native metric list, configured feval or None, tuning metric list)."""
    tuning_objective_metric = None
    configured_feval = None
    cleaned_eval_metrics = None

    if tuning_objective_metric_param is not None:
        components = MetricNameComponents.decode(tuning_objective_metric_param)
        tuning_objective_metric = components.metric_name.split(",")

    union = get_union_metrics(tuning_objective_metric, eval_metric)
    if union is not None:
        feval_metrics = get_custom_metrics(union)
        if feval_metrics:
            configured_feval = configure_feval(feval_metrics)
            cleaned_eval_metrics = [m for m in union if m not in set(feval_metrics)]
        else:
            cleaned_eval_metrics = union

    return cleaned_eval_metrics, configured_feval, tuning_objective_metric


def cleanup_dir(directory, file_prefix):
    """Remove files in ``directory`` that don't start with ``file_prefix``."""
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if os.path.isfile(path) and not name.startswith(file_prefix):
            try:
                os.remove(path)
            except OSError:
                pass
