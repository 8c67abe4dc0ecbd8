"""The cells' inputs, made from the run's seed on the run's device.

One generator a configuration's ``generator`` key names. Both draw with a
``torch.Generator`` on the device, in a few large calls, and hand the rows
to the host once (the port's ``DataMatrix`` takes numpy). The formulas are
frozen copies of the repo's synthetic tasks (``bench.py``'s binary task and
``BENCH_TASK=ranking`` relevance score, ``chip_smoke.py``'s ``make_ranking`` query
sizes), so the benchmark does not change when those files do.

Every seed gets the same amount of work: Higgs's row counts are fixed, and
MSLR's query sizes come from the configuration's fixed ``sizes_seed`` and
are only dealt in another order by the run's seed.
"""

import numpy as np
import torch


class Inputs:
    """Host rows of one run: features f32 [n, d], labels f32 [n], query
    sizes (int64 [q] or None), for the training and the validation split."""

    def __init__(self, x_train, y_train, x_valid, y_valid, groups_train=None,
                 groups_valid=None):
        self.x_train, self.y_train, self.groups_train = x_train, y_train, groups_train
        self.x_valid, self.y_valid, self.groups_valid = x_valid, y_valid, groups_valid


def _generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def higgs(config, seed, device):
    """HIGGS's shape: rows_train + rows_valid rows of ``features``
    standard-normal features; label 1 where 0.8 x0 + 0.5 x1 x2 + sin(x3)
    - 0.2 + N(0, 0.5) > 0."""
    n_train, n_valid, d = config["rows_train"], config["rows_valid"], config["features"]
    n = n_train + n_valid
    g = _generator(seed, device)
    x = torch.randn((n, d), generator=g, device=device)
    noise = torch.randn((n,), generator=g, device=device)
    logit = x[:, 0] * 0.8 + x[:, 1] * x[:, 2] * 0.5 + torch.sin(x[:, 3]) - 0.2
    y = (logit + noise * 0.5 > 0).float()
    x, y = x.cpu().numpy(), y.cpu().numpy()
    return Inputs(x[:n_train], y[:n_train], x[n_train:], y[n_train:])


def query_sizes(config, queries, offset):
    """A fixed set of ``queries`` query sizes: lognormal with mean
    ``docs_mean`` and sigma ``docs_sigma``, rounded, cut to [1, docs_max],
    from ``sizes_seed`` + ``offset`` (the same for every run seed)."""
    rng = np.random.RandomState(config["sizes_seed"] + offset)
    sigma = config["docs_sigma"]
    sizes = np.round(rng.lognormal(np.log(config["docs_mean"]) - sigma ** 2 / 2, sigma, queries))
    return np.clip(sizes, 1, config["docs_max"]).astype(np.int64)


def _ranking_split(sizes, d, quantiles, g, device):
    """Rows of the queries ``sizes`` (dealt in an order drawn from ``g``):
    standard-normal features, relevance 0-4 cut at the ``quantiles`` of
    x0 + sin(x1) + N(0, 0.5)."""
    order = torch.randperm(len(sizes), generator=g, device=device).cpu().numpy()
    sizes = sizes[order]
    n = int(sizes.sum())
    x = torch.randn((n, d), generator=g, device=device)
    score = x[:, 0] + torch.sin(x[:, 1]) + 0.5 * torch.randn((n,), generator=g, device=device)
    q = torch.tensor(quantiles, device=device)
    edges = torch.quantile(score.double(), q.double()).float()
    # np.digitize(score, edges): the number of edges at or below the score
    y = torch.bucketize(score, edges, right=True).float()
    return x.cpu().numpy(), y.cpu().numpy(), sizes


def mslr(config, seed, device):
    """MSLR-WEB30K's shape: ``queries_train`` and ``queries_valid`` query
    groups of ``features`` features and 0-4 relevance in the shares that
    ``relevance_quantiles`` cut."""
    d = config["features"]
    g = _generator(seed, device)
    q = config["relevance_quantiles"]
    xt, yt, st = _ranking_split(query_sizes(config, config["queries_train"], 0), d, q, g, device)
    xv, yv, sv = _ranking_split(query_sizes(config, config["queries_valid"], 1), d, q, g, device)
    return Inputs(xt, yt, xv, yv, st, sv)


GENERATORS = {"higgs": higgs, "mslr": mslr}


def make(config, seed, device):
    return GENERATORS[config["generator"]](config, seed, device)
