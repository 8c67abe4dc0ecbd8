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
    if base == "auc":
        return DeviceMetric(name, lambda m, y, w: _auc_stats(objective_name, m, y, w),
                            lambda s: s[0] / torch.clamp(s[1], min=_EPS))
    return None


def _auc_stats(objective_name, m, y, w):
    """Weighted Mann-Whitney AUC with tie midranks in cumulative-weight
    space -> [auc * pair weight, pair weight] (the JAX device metric's
    form: tie groups from a neighbour-inequality cumsum, segment sums)."""
    p = _prob_transform(objective_name, m)
    n = p.shape[0]
    order = torch.argsort(p, stable=True)
    sp, sw = p[order], w[order]
    pos = (y[order] > 0).to(sw.dtype)
    spos, sneg = pos * sw, (1.0 - pos) * sw
    new_group = torch.ones(n, dtype=torch.long, device=p.device)
    new_group[1:] = (sp[1:] != sp[:-1]).long()
    gid = torch.cumsum(new_group, 0) - 1
    group_w = torch.zeros_like(sw).index_add_(0, gid, sw)
    cumw = torch.cumsum(sw, 0)
    group_end = torch.zeros_like(sw).scatter_reduce_(0, gid, cumw, reduce="amax",
                                                     include_self=False)
    ranks = (group_end - group_w / 2.0)[gid]
    w_pos, w_neg = torch.sum(spos), torch.sum(sneg)
    u = torch.sum(ranks * spos) - w_pos * w_pos / 2.0
    pairw = w_pos * w_neg
    auc = torch.clamp(u / torch.clamp(pairw, min=_EPS), 0.0, 1.0)
    return torch.stack([auc * pairw, pairw])
