"""DART booster: boosting rounds with dropout of earlier trees.

The port's counterpart of ``sagemaker_xgboost_container_tpu/models/dart.py``.
Each round:

* draw a dropped set D of the earlier dropout units (each with probability
  ``rate_drop``, or in proportion to its current weight with
  ``sample_type=weighted``; one forced unit when D comes out empty and
  ``one_drop`` is set; no dropout at all with probability ``skip_drop``);
* compute the gradients at the margins without D and grow a tree with unit
  shrinkage (``ops.tree_build.build_tree``: the ``hist_kernel`` launches at
  levels 0..max_depth-1 and the ``totals_kernel`` one at the last);
* normalize: ``normalize_type=tree`` scales the new tree by eta/(k+eta) and
  D by k/(k+eta), ``forest`` by eta/(1+eta) and 1/(1+eta).

A dropout unit is a boosting round: for a multiclass objective the round's
C trees drop together, and its cached contributions are [n, C], the layout
of the session's margins. The cached per-unit row contributions make
"margins without D" a subtraction. Dart rescales the leaves of earlier trees
in place, so the forest's stacked device copies are dropped after every
round.

The host draws come from one ``np.random.RandomState(seed)`` in the JAX
package's order, so both packages drop the same sets: per round the
skip_drop uniform, the T unit uniforms, the one_drop randint, the
colsample_bytree choice, the subsample uniforms, and a randint that seeds
the round's ``colsample_bylevel`` draws (a ``torch.Generator`` here,
threefry there, so those level masks differ between the packages). As in
the JAX package, ``colsample_bynode`` and the monotone and interaction
constraints are not applied, and ``tree_method=approx`` re-sketches the cuts
before each round's dropout draw.

Across ranks (``group``), as the JAX package's multi-process dart: every
rank's session bins with the merged cuts and reduces each level's
histograms; the draws come from the shared seed, so every rank drops the
same units and draws the same columns; a ``subsample`` draw covers the
global padded rows (every rank padded to the largest count) and each rank
keeps its own segment, so the ranks' generators stay in step; a resumed
run's contributions are each rank's own rows'; the metric lines combine as
in gbtree.

On a grid (``grid``), as the JAX package's dart on a 2-D mesh: the
session keeps each rank's feature shard of the bins and the trees grow over
both axes (``ops/tree_build``); the column draws cover the real global
width, which the builder slices.
"""

import logging

import numpy as np
import torch

from ..ops.predict import forest_leaf_values
from ..ops.split import ColumnMasks
from ..ops.tree_build import build_tree, pack_tree, unpack_tree
from ..toolkit import exceptions as exc
from .forest import compact_padded_tree

logger = logging.getLogger(__name__)


def _resumed_units(forest, session, dtrain):
    """The per-unit contributions of a resumed forest's trees on the
    training rows: [n] a tree, or [n, C] a round for C classes."""
    x = torch.as_tensor(dtrain.features, dtype=torch.float32, device=session.device)
    leaf = forest_leaf_values(forest._stack()[1], x)  # [n, T]
    contribs, slices = [], []
    nclass = session.num_group
    if nclass == 1:
        for i in range(leaf.shape[1]):
            contribs.append(leaf[:, i].contiguous())
            slices.append((i, i + 1))
        return contribs, slices
    indptr = forest.iteration_indptr
    for i in range(len(indptr) - 1):
        s0, s1 = int(indptr[i]), int(indptr[i + 1])
        cols = torch.zeros((leaf.shape[0], nclass), dtype=leaf.dtype, device=leaf.device)
        cols.index_add_(1, torch.as_tensor(forest.tree_info[s0:s1], device=leaf.device),
                        leaf[:, s0:s1])
        contribs.append(cols)
        slices.append((s0, s1))
    return contribs, slices


def train_dart(config, forest, dtrain, evals, feval, callbacks, num_boost_round, device,
               verbose_eval=True, group=None, grid=None):
    """Train ``num_boost_round`` dart rounds onto ``forest`` on ``device``,
    across the ranks of ``group`` (a grid's data group) when one is given,
    and over ``grid``'s feature axis."""
    from .booster import (_TrainingSession, _eval_metric_names, evaluate_host_lines,
                          print_metric_line)

    p = config.objective_params
    rate_drop = float(p.get("rate_drop", 0.0))
    skip_drop = float(p.get("skip_drop", 0.0))
    one_drop = int(p.get("one_drop", 0))
    sample_type = p.get("sample_type", "uniform")
    normalize_type = p.get("normalize_type", "tree")
    eta = config.eta

    for cb in callbacks:
        if getattr(cb, "save_best", False):
            raise exc.UserError(
                "early_stopping with save_best is not supported for booster=dart: "
                "dropout rescales historical trees, so truncating to the best "
                "iteration does not reproduce the best model."
            )
    if config.num_parallel_tree > 1:
        logger.warning(
            "booster=dart ignores num_parallel_tree=%d and builds one tree "
            "per class per round (the dropout unit is the round).",
            config.num_parallel_tree,
        )

    metric_names = _eval_metric_names(config, forest.objective())
    # the eval sets are predicted with the whole (rescaled) forest each
    # round, so the session holds the training rows only
    session = _TrainingSession(config, dtrain, [], forest, metric_names, device, group=group,
                               grid=grid)
    nclass = session.num_group
    n, d = session.bins.shape[0], session.num_col
    draw_rows, own = n, slice(0, n)
    if group is not None and config.subsample < 1.0:
        from ..parallel import collectives

        rank, size = collectives.world(group)
        n_max = int(collectives.host_all_gather(np.asarray([n], np.int64), group,
                                                device).max())
        draw_rows, own = size * n_max, slice(rank * n_max, rank * n_max + n)
    eval_x = [None if dm is dtrain
              else torch.as_tensor(dm.features, dtype=torch.float32, device=device)
              for dm, _name in evals]

    tree_contribs, unit_slices = [], []  # per dropout unit, current scaling
    if forest.trees:
        tree_contribs, unit_slices = _resumed_units(forest, session, dtrain)
    tree_weights = [1.0] * len(tree_contribs)
    rng = np.random.RandomState(config.seed)

    evals_log = {}
    rows_cache = {}   # eval entry -> its global rows (cox-nloglik across ranks)
    for cb in callbacks:
        if hasattr(cb, "before_training"):
            forest = cb.before_training(forest) or forest
    start_round = forest.num_boosted_rounds
    for rnd in range(start_round, start_round + num_boost_round):
        if session.approx_resketch:
            # tree_method=approx: the session re-sketches and re-bins in
            # place, from the whole forest's margins (before the dropped set
            # is drawn), as the JAX package's dart loop does
            session._resketch_bins()
        # ---- the dropped set ---------------------------------------------
        dropped = []
        if tree_contribs and rng.uniform() >= skip_drop:
            T = len(tree_contribs)
            if sample_type == "weighted" and sum(tree_weights) > 0:
                probs = np.asarray(tree_weights) / sum(tree_weights)
                draws = rng.uniform(size=T) < rate_drop * probs * len(probs)
            else:
                draws = rng.uniform(size=T) < rate_drop
            dropped = [int(i) for i in np.flatnonzero(draws)]
            if not dropped and one_drop:
                dropped = [int(rng.randint(T))]

        margins_used = session.margins
        if dropped:
            drop_sum = tree_contribs[dropped[0]]
            for i in dropped[1:]:
                drop_sum = drop_sum + tree_contribs[i]
            margins_used = session.margins - drop_sum
        g, h = session.grad_hess(margins_used)

        tree_mask = None
        if config.colsample_bytree < 1.0:
            k = max(1, int(round(config.colsample_bytree * d)))
            mask = np.zeros(d, np.float32)
            mask[rng.choice(d, size=k, replace=False)] = 1.0
            tree_mask = torch.as_tensor(mask, device=device)[None]
        if config.subsample < 1.0:
            keep = torch.as_tensor(
                (rng.uniform(size=draw_rows)[own] < config.subsample).astype(np.float32),
                device=device)
            keep = keep[:, None] if nclass > 1 else keep
            g, h = g * keep, h * keep
        level_seed = int(rng.randint(2**31))
        level_mask = None
        if config.colsample_bylevel < 1.0:
            gen = torch.Generator(device=device)
            gen.manual_seed(level_seed)
            level_mask = (torch.rand((1, config.max_depth, d), generator=gen, device=device)
                          < config.colsample_bylevel).float()
        masks = None
        if tree_mask is not None or level_mask is not None:
            masks = ColumnMasks(tree_mask, level_mask, None)
        if nclass > 1:
            g, h = g.T.contiguous(), h.T.contiguous()
        tree, row_out = build_tree(
            session.bins, g, h, session.num_cuts, max_depth=config.max_depth,
            num_bins=session.num_bins, reg_lambda=config.reg_lambda, alpha=config.alpha,
            gamma=config.gamma, min_child_weight=config.min_child_weight, eta=1.0,
            max_delta_step=config.max_delta_step, masks=masks, **session.builder_axes())
        if nclass > 1:
            row_out = row_out.T

        # ---- normalization -------------------------------------------------
        k = len(dropped)
        if k == 0:
            new_scale, old_scale = eta, 1.0
        elif normalize_type == "forest":
            new_scale, old_scale = eta / (1.0 + eta), 1.0 / (1.0 + eta)
        else:  # "tree"
            new_scale, old_scale = eta / (k + eta), k / (k + eta)

        new_contrib = row_out * new_scale
        margins = margins_used + new_contrib
        for i in dropped:
            tree_contribs[i] = tree_contribs[i] * old_scale
            tree_weights[i] *= old_scale
            margins = margins + tree_contribs[i]
            s0, s1 = unit_slices[i]
            for t in forest.trees[s0:s1]:
                t.value *= old_scale
        session.margins = margins
        tree_contribs.append(new_contrib)
        tree_weights.append(new_scale)

        host = unpack_tree(pack_tree(tree).cpu().numpy())
        host["leaf_value"] = host["leaf_value"] * new_scale
        host["base_weight"] = host["base_weight"] * new_scale
        if nclass > 1:
            trees = [compact_padded_tree({key: v[c] for key, v in host.items()}, session.cuts)
                     for c in range(nclass)]
        else:
            trees = [compact_padded_tree(host, session.cuts)]
        # append_round also drops the stacked copies of the rescaled trees
        forest.append_round(trees, list(range(nclass)))
        unit_slices.append((len(forest.trees) - nclass, len(forest.trees)))

        # ---- eval: the whole (rescaled) forest ------------------------------
        entries = []
        for (dm, name), xe in zip(evals, eval_x):
            margin = (session.margins.cpu().numpy() if xe is None
                      else forest.predict_margin(xe))
            entries.append((name, dm, margin))
        results = evaluate_host_lines(entries, metric_names, feval, session.objective, nclass,
                                      group=session.group, device=device,
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
