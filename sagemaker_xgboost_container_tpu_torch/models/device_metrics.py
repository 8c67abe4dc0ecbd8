"""Eval metrics on the device, as summable partial statistics.

Every metric decomposes into a fixed-size statistics vector plus a cheap
``finalize`` that turns the stats into the scalar. Weighted formulations
throughout.
"""

import torch

_EPS = 1e-15


class DeviceMetric:
    """A decomposable metric: ``partial`` -> f32 stats -> ``finalize``."""

    def __init__(self, name, partial, finalize):
        self.name = name
        self.partial = partial
        self.finalize = finalize

    def __call__(self, margins, labels, weights):
        return self.finalize(self.partial(margins, labels, weights))


def _sigmoid(m):
    return 1.0 / (1.0 + torch.exp(-m))


def _prob_transform(objective_name, margins):
    if objective_name in ("reg:logistic", "binary:logistic"):
        return _sigmoid(margins)
    return margins


def _weighted_mean_metric(name, objective_name, term_fn, post=None):
    """Metric = post(sum(w * term) / sum(w)); stats vector [num, den]."""

    def partial(m, y, w):
        p = _prob_transform(objective_name, m)
        return torch.stack([torch.sum(term_fn(p, y, w) * w), torch.sum(w)])

    def finalize(stats):
        mean = stats[0] / torch.clamp(stats[1], min=_EPS)
        return post(mean) if post is not None else mean

    return DeviceMetric(name, partial, finalize)


def make_device_metric(name, objective_name):
    """-> DeviceMetric, or None if the metric is not ported."""
    base, _, suffix = name.partition("@")

    def wm(term_fn, post=None):
        return _weighted_mean_metric(name, objective_name, term_fn, post)

    if base == "rmse":
        return wm(lambda p, y, w: (p - y) ** 2, post=torch.sqrt)
    if base == "logloss":
        def term(p, y, w):
            # f32-safe: clip with an epsilon representable in float32
            eps32 = 1e-7
            p = torch.clamp(p, eps32, 1 - eps32)
            return -(y * torch.log(p) + (1 - y) * torch.log(1 - p))

        return wm(term)
    if base == "error":
        threshold = float(suffix) if suffix else 0.5
        return wm(lambda p, y, w: ((p > threshold).float() != y).float())
    return None
