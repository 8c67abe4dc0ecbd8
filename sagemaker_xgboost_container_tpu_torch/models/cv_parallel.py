"""Fold-parallel k-fold CV: every fold of a cross-validation in one tree build.

The port's counterpart of ``sagemaker_xgboost_container_tpu/models/cv_parallel.py``.
Every fold trains on the same rows with another weight mask (held-out rows
weigh 0, so they drop out of the histograms and the training metrics as
xgboost's row slicing drops them), so the F folds of a job are the class
axis of one ``build_tree``: margins and gradients are [F, n], and each level
is one ``level_histogram`` launch, and each tree one ``node_totals``
launch, for all F folds. The JAX package vmaps its builder over the folds
and shards them over devices; on one GPU the class axis does it.

``_rounds_per_dispatch`` K runs K rounds a dispatch, as the JAX package's
scan does: their trees and metric values reach the host in one copy. The
rounds run eagerly (the session's CUDA graph, ``models/round_graph``, is
not used here).

Scope, as in the JAX package: gbtree, depthwise growth, one output group,
``num_parallel_tree`` 1, no ranking or Cox objective, and metrics with a
device form, without a feval. The entry point falls back to the sequential
fold loop otherwise.

Binning: the cut points are computed once over the whole train+validation
matrix (feature values and weights, no labels), where the sequential path
sketches each fold's training rows, so the two paths can grow slightly
different trees; ``GRAFT_PARALLEL_CV=0`` makes the entry point take the
sequential path. Under ``tree_method=approx`` that one sketch stays for
every round, as in the JAX package, where the sequential path re-sketches
each round. The monotone and interaction constraints apply to every fold.
"""

import numpy as np
import torch

from ..data.binning import bin_matrix
from ..telemetry import REGISTRY
from ..ops.tree_build import build_tree, pack_tree, unpack_tree
from .booster import constraint_tensors
from .device_metrics import make_device_metric
from .forest import compact_padded_tree
from .sampling import Sampler


def parallel_cv_supported(config, metric_names, has_feval):
    """Static eligibility for the fold-parallel path."""
    if has_feval or not metric_names:
        return False
    if config.booster != "gbtree" or config.grow_policy != "depthwise":
        return False
    if config.num_class > 1 or config.num_parallel_tree > 1:
        return False
    if config.objective.startswith("rank:") or config.objective == "survival:cox":
        return False
    return all(make_device_metric(name, config.objective, 1, config.objective_params)
               is not None for name in metric_names)


def train_cv_parallel(config, dmatrix, splits, num_boost_round, metric_names, forest_factory,
                      device, _sampler=None):
    """Train the folds of ``splits`` ([(train_idx, val_idx)] over
    ``dmatrix``'s rows) side by side on ``device``. -> (forests,
    evals_results), the latter per fold {"train": {metric: [value a
    round]}, "validation": {...}}, as the sequential fold loop records them.
    ``_sampler``: as ``booster.train``'s, with one stream a fold."""
    F = len(splits)
    binned = bin_matrix(dmatrix, config.max_bin, exact_cap=config.exact_bin_cap)
    n, d = binned.bins.shape
    num_bins = binned.num_bins
    base_w = np.asarray(dmatrix.get_weight(), np.float32)
    train_w = np.zeros((F, n), np.float32)
    val_w = np.zeros((F, n), np.float32)
    for k, (tr_idx, va_idx) in enumerate(splits):
        train_w[k, tr_idx] = base_w[tr_idx]
        val_w[k, va_idx] = base_w[va_idx]

    forests = [forest_factory() for _ in range(F)]
    objective = forests[0].objective()
    metric_fns = [make_device_metric(name, config.objective, 1, config.objective_params)
                  for name in metric_names]

    bins = torch.as_tensor(binned.bins, device=device)
    labels = torch.as_tensor(np.asarray(dmatrix.labels, np.float32), device=device)
    num_cuts = torch.as_tensor(
        np.asarray([len(c) for c in binned.cut_points], np.int32), device=device)
    train_w = torch.as_tensor(train_w, device=device)
    val_w = torch.as_tensor(val_w, device=device)
    monotone, interaction_sets = constraint_tensors(config, d, device)
    margins = torch.full((F, n), objective.base_margin(forests[0].base_score),
                         dtype=torch.float32, device=device)
    sampler = _sampler
    if sampler is None and Sampler.needed(config):
        sampler = Sampler(config, n, d, device, streams=F)

    # K rounds a dispatch, as the JAX package's scan: their trees and
    # metric values reach the host in one copy
    k_rounds = max(1, config.rounds_per_dispatch)
    REGISTRY.gauge(
        "dispatch_fused_rounds",
        "Boosting rounds fused into one device dispatch per round "
        "program (the lax.scan length K of the fused round pipeline)",
    ).set(k_rounds)

    def fold_round(rnd):
        """Round ``rnd`` of every fold -> (packed trees [10, F, max_nodes],
        metric values [F, n_metrics, 2]) on the device."""
        g, h = objective.grad_hess(margins, labels, train_w)
        masks = None
        if sampler is not None:
            keep, masks = sampler.draw(rnd)[0]
            if keep is not None:
                g, h = g * keep, h * keep
        tree, row_out = build_tree(
            bins, g, h, num_cuts, max_depth=config.max_depth, num_bins=num_bins,
            reg_lambda=config.reg_lambda, alpha=config.alpha, gamma=config.gamma,
            min_child_weight=config.min_child_weight, eta=config.eta,
            max_delta_step=config.max_delta_step, masks=masks, monotone=monotone,
            interaction_sets=interaction_sets,
        )
        margins.add_(row_out)
        # per fold: each metric on the training rows, then the held-out ones
        stats = torch.stack([fn(margins[k], labels, w[k]).double() for k in range(F)
                             for fn in metric_fns for w in (train_w, val_w)])
        return pack_tree(tree), stats.reshape(F, len(metric_fns), 2)

    evals_results = [{"train": {m: [] for m in metric_names},
                      "validation": {m: [] for m in metric_names}} for _ in range(F)]
    rnd = 0
    while rnd < num_boost_round:
        outs = [fold_round(r) for r in range(rnd, min(rnd + k_rounds, num_boost_round))]
        packed = torch.stack([p for p, _ in outs])
        flat = torch.cat([packed.reshape(-1).double()]
                         + [s.reshape(-1) for _, s in outs]).cpu().numpy()
        host = flat[:packed.numel()].reshape(tuple(packed.shape))
        values = flat[packed.numel():].reshape(len(outs), F, len(metric_fns), 2)
        for j in range(len(outs)):
            trees = unpack_tree(host[j])
            for k in range(F):
                forests[k].append_round(
                    [compact_padded_tree({key: v[k] for key, v in trees.items()},
                                         binned.cut_points)], [0])
                for i, m in enumerate(metric_names):
                    evals_results[k]["train"][m].append(float(values[j, k, i, 0]))
                    evals_results[k]["validation"][m].append(float(values[j, k, i, 1]))
        rnd += len(outs)
    return forests, evals_results
