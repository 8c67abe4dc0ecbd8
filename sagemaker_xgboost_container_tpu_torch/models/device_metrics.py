"""Eval metrics on the device, as summable partial statistics.

Every metric decomposes into a fixed-size statistics vector plus a cheap
``finalize`` that turns the stats into the scalar. Weighted formulations
throughout. Metrics without a device form (``mphe``, ``aucpr``,
``aft-nloglik``, ...) are evaluated on the host by ``eval_metrics``.
"""

import torch

_EPS = 1e-15


class DeviceMetric:
    """A decomposable metric: ``partial`` -> f32 stats -> ``finalize``.
    ``needs_global_rows``: the stats of two row sets do not sum to the
    stats of their union (``cox-nloglik``: a row's risk set spans every
    row), so across ranks the metric is computed on the gathered rows."""

    def __init__(self, name, partial, finalize, needs_global_rows=False):
        self.name = name
        self.partial = partial
        self.finalize = finalize
        self.needs_global_rows = needs_global_rows

    def __call__(self, margins, labels, weights):
        return self.finalize(self.partial(margins, labels, weights))


def _sigmoid(m):
    return 1.0 / (1.0 + torch.exp(-m))


def _softmax(m):
    e = torch.exp(m - torch.amax(m, dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


_EXP_OBJECTIVES = ("count:poisson", "reg:gamma", "reg:tweedie", "survival:aft",
                   "survival:cox")


def _prob_transform(objective_name, margins):
    """What the metric sees: the objective's prediction, as the JAX
    package's host metrics see it (binary:hinge predicts 0 or 1)."""
    if objective_name in ("reg:logistic", "binary:logistic"):
        return _sigmoid(margins)
    if objective_name in _EXP_OBJECTIVES:
        return torch.exp(margins)
    if objective_name == "binary:hinge":
        return (margins > 0).to(margins.dtype)
    return margins


def _weighted_mean_metric(name, objective_name, term_fn, post=None):
    """Metric = post(sum(w * term) / sum(w)); stats vector [num, den]."""

    def partial(m, y, w):
        p = _prob_transform(objective_name, m)
        num = torch.sum(term_fn(p, y, w) * w)
        return torch.stack([num, torch.sum(w).to(num.dtype)])

    def finalize(stats):
        mean = stats[0] / torch.clamp(stats[1], min=_EPS)
        return post(mean) if post is not None else mean

    return DeviceMetric(name, partial, finalize)


def _ratio(stats):
    return stats[0] / torch.clamp(stats[1], min=_EPS)


def make_device_metric(name, objective_name, num_group=1, params=None):
    """-> DeviceMetric, or None where the metric has no device form (the
    booster then evaluates it on the host, ``eval_metrics``)."""
    params = params or {}
    base, _, suffix = name.partition("@")

    if num_group > 1:
        if base == "merror":
            def partial(m, y, w):
                wrong = (torch.argmax(m, dim=1) != y.long()).to(w.dtype)
                return torch.stack([torch.sum(wrong * w), torch.sum(w)])

            return DeviceMetric(name, partial, _ratio)
        if base == "mlogloss":
            def partial(m, y, w):
                picked = torch.gather(_softmax(m), 1, y.long()[:, None])[:, 0]
                v = -torch.log(torch.clamp(picked, _EPS, 1.0))
                return torch.stack([torch.sum(v * w), torch.sum(w)])

            return DeviceMetric(name, partial, _ratio)
        return None

    def wm(term_fn, post=None):
        return _weighted_mean_metric(name, objective_name, term_fn, post)

    if base == "rmse":
        return wm(lambda p, y, w: (p - y) ** 2, post=torch.sqrt)
    if base == "mse":
        return wm(lambda p, y, w: (p - y) ** 2)
    if base == "mae":
        return wm(lambda p, y, w: torch.abs(p - y))
    if base == "mape":
        return wm(lambda p, y, w: torch.abs((y - p) / torch.clamp(torch.abs(y), min=_EPS)))
    if base == "rmsle":
        return wm(
            lambda p, y, w: (torch.log1p(torch.clamp(p, min=0.0)) - torch.log1p(y)) ** 2,
            post=torch.sqrt,
        )
    if base == "logloss":
        def term(p, y, w):
            # f64, as the host metric: in f32, 1 - 1e-15 rounds to 1.0, and
            # binary:logitraw's raw margins reach the clip
            p = torch.clamp(p.double(), _EPS, 1 - _EPS)
            return -(y * torch.log(p) + (1 - y) * torch.log(1 - p))

        return wm(term)
    if base == "error":
        threshold = float(suffix) if suffix else 0.5
        return wm(lambda p, y, w: ((p > threshold).float() != y).float())
    if base == "auc":
        return DeviceMetric(name, lambda m, y, w: _auc_stats(objective_name, m, y, w),
                            _ratio)
    if base == "poisson-nloglik":
        def term(p, y, w):
            p = torch.clamp(p, min=_EPS)
            return p - y * torch.log(p) + torch.lgamma(y + 1.0)

        return wm(term)
    if base == "gamma-nloglik":
        def term(p, y, w):
            p = torch.clamp(p, min=_EPS)
            return torch.log(p) + y / p

        return wm(term)
    if base == "gamma-deviance":
        def term(p, y, w):
            p = torch.clamp(p, min=_EPS)
            yy = torch.clamp(y, min=_EPS)
            return torch.log(p / yy) + yy / p - 1.0

        return wm(term, post=lambda x: 2.0 * x)
    if base == "cox-nloglik":
        return DeviceMetric(name, _cox_stats,
                            lambda s: s[0] / torch.clamp(s[1], min=1e-12),
                            needs_global_rows=True)
    if base == "tweedie-nloglik":
        rho = float(suffix) if suffix else float(params.get("tweedie_variance_power", 1.5))

        def term(p, y, w):
            p = torch.clamp(p, min=_EPS)
            a = y * torch.pow(p, 1 - rho) / (1 - rho)
            b = torch.pow(p, 2 - rho) / (2 - rho)
            return -a + b

        return wm(term)
    return None


def _cox_stats(m, y, w):
    """Negative Breslow partial log-likelihood -> [-ll, event weight]:
    labels < 0 are censored at |t|, the hazard ratio is exp(margin), risk
    sets are cumulative sums over the descending-time order (stable)."""
    p = torch.exp(m)
    event = (y > 0).to(m.dtype)
    order = torch.argsort(-torch.abs(y), stable=True)
    hz = torch.clamp(p, min=1e-30)[order] * w[order]
    cum = torch.cumsum(hz, 0)
    ev = (event * w)[order]
    ll = torch.sum(
        ev * (torch.log(torch.clamp(hz, min=1e-30)) - torch.log(torch.clamp(cum, min=1e-30)))
    )
    return torch.stack([-ll, torch.sum(ev)])


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
