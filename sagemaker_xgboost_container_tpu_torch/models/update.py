"""process_type=update: refresh and prune the trees of an existing model on
(new) data.

The port's counterpart of ``sagemaker_xgboost_container_tpu/models/update.py``
(xgboost's TreeRefresher and TreePruner):

* round i processes the loaded model's round-i trees and grows none; the
  gradients come from the margins of the rounds processed so far, as in
  boosting, and ``num_boost_round`` is capped at the model's round count;
* ``refresh``: route the training rows through each tree, rebuild every
  node's (sum_g, sum_h), store sum_hess, recompute the split gains
  (0.5 * (score_L + score_R - score_parent)) and, with ``refresh_leaf``
  (default 1), set the leaf values to eta times the optimal weight;
* ``prune``: bottom up, a split whose children are both leaves and whose
  recomputed gain is below ``gamma`` becomes a leaf valued eta times its
  base weight. The stats are recomputed from the update data first in
  every case (the leaf values change only with ``refresh``).

Rows are routed on the device (``ops.predict.forest_leaf_nodes``); the
node statistics and both updaters are host numpy in float64.

Across ranks (``group``), as the JAX package's multi-process update (and
libxgboost's TreeRefresher under Rabit): each rank routes its own rows, and
every tree's per-node (sum_g, sum_h) is gathered in float32 and summed in
float64 in rank order before the refresh and prune math, so every rank
updates the trees identically. ``survival:cox`` computes its gradients on
the gathered global rows (``booster.GlobalRows``).
"""

import numpy as np
import torch

from ..ops.predict import forest_leaf_nodes
from ..toolkit import exceptions as exc


def _node_depth_order(tree):
    """Node indices deepest first (children before parents). The root's
    parent is xgboost's 2147483647 marker; any parent out of range means
    none."""
    n = tree.num_nodes
    depth = np.zeros(n, np.int32)
    for node in range(n):
        p = tree.parent[node]
        if 0 <= p < n and p != node:
            depth[node] = depth[p] + 1
    return np.argsort(-depth, kind="stable"), depth


def _score(g, h, reg_lambda, alpha):
    t = np.sign(g) * np.maximum(np.abs(g) - alpha, 0.0)
    return (t * t) / (h + reg_lambda)


def _refresh_tree(tree, leaf_of_row, g, h, config, refresh_leaf, combine=None):
    """Rebuild the node stats of ``tree`` from the rows routed to each of
    its leaves; with ``refresh_leaf`` also its leaf values. ``combine``
    (across ranks) sums the per-leaf stats [2, nodes] over the ranks."""
    n_nodes = tree.num_nodes
    G = np.zeros(n_nodes, np.float64)
    H = np.zeros(n_nodes, np.float64)
    np.add.at(G, leaf_of_row, g)
    np.add.at(H, leaf_of_row, h)
    if combine is not None:
        G, H = combine(np.stack([G, H]))
    order, _depth = _node_depth_order(tree)
    for node in order:  # children accumulate into parents, deepest first
        p = tree.parent[node]
        if 0 <= p < n_nodes and p != node:
            G[p] += G[node]
            H[p] += H[node]

    lam, alpha = config.reg_lambda, config.alpha
    weight = -np.sign(G) * np.maximum(np.abs(G) - alpha, 0.0) / (H + lam)
    if config.max_delta_step > 0:
        weight = np.clip(weight, -config.max_delta_step, config.max_delta_step)

    tree.sum_hess = H.astype(np.float32)
    tree.base_weight = weight.astype(np.float32)
    is_leaf = tree.is_leaf
    internal = ~is_leaf
    l, r = tree.left, tree.right
    gain = np.zeros(n_nodes, np.float32)
    gain[internal] = 0.5 * (
        _score(G[l[internal]], H[l[internal]], lam, alpha)
        + _score(G[r[internal]], H[r[internal]], lam, alpha)
        - _score(G[internal], H[internal], lam, alpha)
    )
    tree.gain = gain
    if refresh_leaf:
        tree.value = np.where(is_leaf, (config.eta * weight).astype(np.float32), tree.value)


def _prune_tree(tree, gamma, eta):
    """Bottom up: collapse splits with two leaf children and gain < gamma
    into leaves valued eta * base_weight."""
    order, _depth = _node_depth_order(tree)
    is_leaf = tree.is_leaf.copy()
    for node in order:
        if is_leaf[node]:
            continue
        l, r = tree.left[node], tree.right[node]
        if is_leaf[l] and is_leaf[r] and tree.gain[node] < gamma:
            is_leaf[node] = True
            tree.left[node] = -1
            tree.right[node] = -1
            tree.value[node] = eta * tree.base_weight[node]


def train_update(config, forest, dtrain, evals, feval, callbacks, num_boost_round,
                 verbose_eval=True, group=None):
    """Apply the refresh / prune updaters to ``forest`` over ``dtrain`` on
    the forest's device, across the ranks of ``group`` when one is given."""
    from ..parallel import collectives
    from .booster import GlobalRows, _eval_metric_names, evaluate_host_lines, print_metric_line

    updaters = [u.strip() for u in str(config.objective_params.get("updater", "refresh"))
                .split(",") if u.strip()]
    if any(u not in ("refresh", "prune") for u in updaters):
        raise exc.UserError(
            "process_type 'update' can only be used with updater 'refresh' and 'prune'"
        )
    refresh_leaf = int(config.objective_params.get("refresh_leaf", 1) or 0)
    if not forest.trees:
        raise exc.UserError(
            "process_type='update' needs an existing model to update "
            "(provide a checkpoint / base_model)."
        )
    dev = forest.device
    objective = forest.objective()
    objective.validate_labels(dtrain.labels)
    G_out = forest.num_output_group
    n = dtrain.num_row
    x = torch.as_tensor(dtrain.features, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(dtrain.labels, device=dev)
    weights = torch.as_tensor(dtrain.get_weight(), device=dev)
    base = objective.base_margin(forest.base_score)
    margins = torch.full((n,) if G_out == 1 else (n, G_out), base, dtype=torch.float32,
                         device=dev)
    eval_x = [x if dm is dtrain else torch.as_tensor(dm.features, dtype=torch.float32,
                                                       device=dev)
              for dm, _name in evals]

    combine = global_rows = None
    if group is not None:
        def combine(stats):
            every = collectives.host_all_gather(stats.astype(np.float32), group, dev,
                                                kind="update")
            return every.astype(np.float64).sum(axis=0)

        if objective.name == "survival:cox":
            global_rows = GlobalRows(dtrain.labels, dtrain.get_weight(), group, dev)

    rounds = min(num_boost_round, forest.num_boosted_rounds)
    metric_names = _eval_metric_names(config, objective)
    evals_log = {}
    rows_cache = {}   # eval entry -> its global rows (cox-nloglik across ranks)
    for cb in callbacks:
        if hasattr(cb, "before_training"):
            forest = cb.before_training(forest) or forest
    for rnd in range(rounds):
        if global_rows is not None:
            g, h = global_rows.grad_hess(objective, margins)
        else:
            g, h = objective.grad_hess(margins, labels, weights)
        g = g.cpu().numpy().astype(np.float64)
        h = h.cpu().numpy().astype(np.float64)
        t0, t1 = forest.iteration_indptr[rnd], forest.iteration_indptr[rnd + 1]
        leaf_nodes = forest_leaf_nodes(forest._stack(t0, t1)[1], x).cpu().numpy()
        for j, t in enumerate(range(t0, t1)):
            tree = forest.trees[t]
            cls = forest.tree_info[t]
            # stats always recomputed (one gain convention for prune); leaf
            # values replaced only when refresh was asked for
            _refresh_tree(tree, leaf_nodes[:, j], g if g.ndim == 1 else g[:, cls],
                          h if h.ndim == 1 else h[:, cls], config,
                          refresh_leaf and "refresh" in updaters, combine=combine)
            if "prune" in updaters:
                _prune_tree(tree, config.gamma, config.eta)
        forest.release()  # the stacked trees changed
        # margins advance with the updated trees (pruning may have changed
        # the routing), tree by tree in round order
        stacked = forest._stack(t0, t1)[1]
        leaf_nodes = forest_leaf_nodes(stacked, x)
        contrib = torch.gather(stacked["leaf_value"].T, 0, leaf_nodes)  # [n, T]
        for j, t in enumerate(range(t0, t1)):
            if G_out == 1:
                margins += contrib[:, j]
            else:
                margins[:, forest.tree_info[t]] += contrib[:, j]

        entries = [(name, dm, forest.predict_margin(xe, iteration_range=(0, rnd + 1)))
                   for (dm, name), xe in zip(evals, eval_x)]
        results = evaluate_host_lines(entries, metric_names, feval, objective, G_out,
                                      group=group, device=dev,
                                      objective_params=config.objective_params,
                                      rows_cache=rows_cache)
        for data_name, metric_name, value in results:
            evals_log.setdefault(data_name, {}).setdefault(metric_name, []).append(value)
        if verbose_eval:
            print_metric_line(rnd, results)
        stops = [cb.after_iteration(forest, rnd, evals_log)
                 for cb in callbacks if hasattr(cb, "after_iteration")]
        if any(stops):
            break
    for cb in callbacks:
        if hasattr(cb, "after_training"):
            forest = cb.after_training(forest) or forest
    return forest
