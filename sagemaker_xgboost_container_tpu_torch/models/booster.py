"""The boosting engine: ``train()``, the counterpart of ``xgb.train``.

One device, eager PyTorch: each round computes the objective's grad/hess
(LambdaMART gradients over the query groups for the ranking objectives,
``ops/ranking``), grows one tree, or one per class for a multiclass
objective, all C in one loop (``ops/tree_build.build_tree`` level by level,
or ``ops/lossguide.build_tree_lossguide`` split by split, on [C, n]
gradients), adds the
trees' row outputs to the training margins ([n] or [n, C]) and their
predictions to every eval set's margins, evaluates the eval metrics (on the
device where the metric has a device form, else on the host), and commits
the compacted trees to the Forest. The only host work per round is pulling
the trees' small node arrays and the metric scalars.

Callback protocol mirrors xgboost's (before_training / after_iteration ->
bool stop / after_training), which is how early stopping hooks in.
"""

import numpy as np
import torch

from .._device import resolve_device
from ..data.binning import bin_matrix
from ..ops.lossguide import build_tree_lossguide
from ..ops.predict import forest_leaf_values
from ..ops.ranking import bucket_group_layout, lambdarank_grad_hess
from ..ops.tree_build import build_tree, pack_tree, predict_binned, unpack_tree
from ..toolkit import exceptions as exc
from . import eval_metrics
from .device_metrics import make_device_metric
from .forest import Forest, compact_padded_tree
from .objectives import SoftprobMulti, create_objective

# objective hyperparameters carried into the saved model
OBJECTIVE_PARAM_KEYS = (
    "scale_pos_weight",
    "tweedie_variance_power",
    "huber_slope",
    "max_delta_step",
    "num_class",
    "aft_loss_distribution",
    "aft_loss_distribution_scale",
)
# trees traversed together when a resumed run rebuilds its margins
_RESUME_TREES_PER_PASS = 64


class TrainConfig:
    """Parsed + defaulted booster parameters of the ported slice.

    Takes every key that ``algorithm.hyperparameters`` validates and every
    objective (``num_class`` >= 2 for multiclass), with depthwise or
    lossguide growth (``max_leaves`` set; ``max_depth`` 0 only there).
    Keys that do not change a gbtree model (``updater``, ``predictor``,
    ``nthread``, ``verbosity``, ``seed``, the dart and gblinear knobs, ...)
    are accepted and ignored, as the JAX package ignores them there. What
    the port does not train raises ``UserError`` naming the parameter,
    rather than training something else: ``subsample`` and ``colsample_*``
    below 1, ``num_parallel_tree`` above 1, monotone and interaction
    constraints, dart, gblinear, ``process_type=update`` and the exact and
    approx tree methods.
    """

    def __init__(self, params):
        p = dict(params or {})
        self.eta = float(p.get("eta", 0.3))
        max_depth = p.get("max_depth", 6)
        self.max_depth = int(max_depth) if max_depth is not None else 6
        self.grow_policy = p.get("grow_policy", "depthwise")
        self.max_leaves = int(p.get("max_leaves", 0) or 0)
        if self.grow_policy == "lossguide" and self.max_leaves <= 0:
            # xgboost's 0 means unlimited; the builder's node slots need a bound
            raise exc.UserError("grow_policy='lossguide' requires max_leaves >= 2")
        if self.max_depth < 1 and not (self.grow_policy == "lossguide" and self.max_depth == 0):
            raise exc.UserError(
                "max_depth must be >= 1 for grow_policy='depthwise'; max_depth=0 "
                "(unlimited depth) needs grow_policy='lossguide' with max_leaves"
            )
        # routing passes that take a row to its leaf in any tree
        self.predict_depth = (
            (self.max_depth if self.max_depth > 0 else self.max_leaves - 1)
            if self.grow_policy == "lossguide"
            else self.max_depth
        )
        self.reg_lambda = float(p.get("lambda", 1.0))
        self.alpha = float(p.get("alpha", 0.0))
        self.gamma = float(p.get("gamma", 0.0))
        self.min_child_weight = float(p.get("min_child_weight", 1.0))
        self.max_delta_step = float(p.get("max_delta_step", 0.0))
        if p.get("max_bin") is not None:
            self.max_bin = int(p["max_bin"])
        elif p.get("sketch_eps"):
            # bins ~ 1/eps, the JAX package's reading of sketch_eps
            self.max_bin = int(min(max(1.0 / float(p["sketch_eps"]), 2), 1024))
        else:
            self.max_bin = 256
        self.seed = int(p.get("seed", 0))
        self.objective = p.get("objective", "reg:squarederror")
        self.num_class = int(p.get("num_class", 0) or 0)
        self.base_score = float(p.get("base_score", 0.5))
        self.eval_metric = p.get("eval_metric")
        self.objective_params = p
        if self.objective == "count:poisson" and "max_delta_step" not in p:
            self.max_delta_step = 0.7

        unsupported = []
        for key in ("subsample", "colsample_bytree", "colsample_bylevel", "colsample_bynode"):
            if float(p.get(key, 1.0)) < 1.0:
                unsupported.append("{}={}".format(key, p[key]))
        checks = (
            ("grow_policy", "depthwise", lambda v: v in ("depthwise", "lossguide")),
            ("tree_method", "auto", lambda v: v in ("auto", "hist")),
            ("booster", "gbtree", lambda v: v == "gbtree"),
            ("num_parallel_tree", 1, lambda v: int(v or 1) == 1),
            ("process_type", "default", lambda v: v == "default"),
            ("monotone_constraints", None, lambda v: not v),
            ("interaction_constraints", None, lambda v: not v),
        )
        for key, default, ok in checks:
            if not ok(p.get(key, default)):
                unsupported.append("{}={!r}".format(key, p[key]))
        if unsupported:
            raise exc.UserError(
                "not supported by the PyTorch port yet: {}".format(", ".join(unsupported))
            )


def _eval_metric_names(config, objective):
    metrics = config.eval_metric
    if metrics is None:
        metrics = [objective.default_metric]
    elif isinstance(metrics, str):
        metrics = [metrics]
    return list(metrics)


class _TrainingSession:
    """Device state for one training run: bins, margins, eval sets."""

    def __init__(self, config, dtrain, evals, forest, metric_names, device):
        self.config = config
        self.device = device
        self.objective = forest.objective()
        self.num_group = self.objective.num_output_group
        self.objective.validate_labels(dtrain.labels)

        self.train_binned = bin_matrix(dtrain, config.max_bin)
        self.cuts = self.train_binned.cut_points
        self.num_bins = self.train_binned.num_bins
        self.bins = torch.as_tensor(self.train_binned.bins, device=device)
        self.num_cuts = torch.as_tensor(
            np.asarray([len(c) for c in self.cuts], np.int32), device=device
        )
        self.labels = torch.as_tensor(dtrain.labels, device=device)
        self.weights = torch.as_tensor(dtrain.get_weight(), device=device)
        # ranking: the query groups as row-index blocks, once (a matrix
        # without groups is one group of all its rows, as in xgboost)
        self.rank_blocks = None
        if self.objective.needs_groups:
            groups = [dtrain.num_row] if dtrain.groups is None else dtrain.groups
            self.rank_blocks = [torch.as_tensor(b, device=device)
                                for b in bucket_group_layout(groups)]
        base = self.objective.base_margin(forest.base_score)
        self.margins = self._start_margins(forest, dtrain, base)

        # each metric on the device where it has a device form, else on the
        # host (None), as the JAX package evaluates it
        self.metrics = []
        for name in metric_names:
            m = make_device_metric(name, self.objective.name, self.num_group,
                                   config.objective_params)
            if m is None and not eval_metrics.is_native_metric(name):
                raise exc.UserError(
                    "eval_metric {!r} is not supported by the PyTorch port yet".format(name)
                )
            self.metrics.append((name, m))

        # eval sets: bins and labels on the device once, margins incremental;
        # the training matrix itself shares the training margins
        self.eval_sets = []
        for dm, name in evals:
            if dm is dtrain:
                self.eval_sets.append((name, dm, None, self.labels, self.weights, None))
                continue
            binned = bin_matrix(dm, config.max_bin, cut_points=self.cuts)
            self.eval_sets.append((
                name,
                dm,
                torch.as_tensor(binned.bins, device=device),
                torch.as_tensor(dm.labels, device=device),
                torch.as_tensor(dm.get_weight(), device=device),
                self._start_margins(forest, dm, base),
            ))

    def _start_margins(self, forest, dm, base):
        """Margins of ``dm``'s rows before the first new round ([n], or
        [n, C] for a multi-output objective): the base margin plus the
        resumed forest's trees, added one tree at a time in round order into
        their class's column, as the rounds added them, so that a resumed
        run's margins equal an uninterrupted run's bit for bit."""
        shape = (dm.num_row,) if self.num_group == 1 else (dm.num_row, self.num_group)
        margins = torch.full(shape, base, dtype=torch.float32, device=self.device)
        if forest.trees:
            x = torch.as_tensor(dm.features, device=self.device)
            for lo in range(0, len(forest.trees), _RESUME_TREES_PER_PASS):
                hi = min(lo + _RESUME_TREES_PER_PASS, len(forest.trees))
                _, stacked = forest._stack(lo, hi)
                leaves = forest_leaf_values(stacked, x).unbind(1)
                for leaf, cls in zip(leaves, forest.tree_info[lo:hi]):
                    if self.num_group == 1:
                        margins += leaf
                    else:
                        margins[:, cls] += leaf
        return margins

    def run_round(self):
        """Grow one round's trees and update every margin -> host tree dict
        (arrays [max_nodes], or [C, max_nodes] for C classes)."""
        cfg = self.config
        if self.rank_blocks is not None:
            g, h = lambdarank_grad_hess(self.margins, self.labels, self.weights,
                                        self.rank_blocks, scheme=self.objective.scheme)
        else:
            g, h = self.objective.grad_hess(self.margins, self.labels, self.weights)
        if self.num_group > 1:
            # [n, C] -> the builder's contiguous [C, n]
            g, h = g.T.contiguous(), h.T.contiguous()
        common = dict(
            num_bins=self.num_bins, max_depth=cfg.max_depth,
            reg_lambda=cfg.reg_lambda, alpha=cfg.alpha, gamma=cfg.gamma,
            min_child_weight=cfg.min_child_weight, eta=cfg.eta,
            max_delta_step=cfg.max_delta_step,
        )
        if cfg.grow_policy == "lossguide":
            tree, row_out = build_tree_lossguide(
                self.bins, g, h, self.num_cuts, max_leaves=cfg.max_leaves, **common)
        else:
            tree, row_out = build_tree(self.bins, g, h, self.num_cuts, **common)
        self.margins += row_out if self.num_group == 1 else row_out.T
        for _name, _dm, bins, _labels, _weights, margins in self.eval_sets:
            if bins is not None:
                out = predict_binned(tree, bins, cfg.predict_depth, self.num_bins)
                margins += out if self.num_group == 1 else out.T
        return unpack_tree(pack_tree(tree))

    def evaluate(self):
        """-> list of (data_name, metric_name, value) per eval set."""
        results = []
        for name, dm, _bins, labels, weights, margins in self.eval_sets:
            m = self.margins if margins is None else margins
            host = None
            for metric_name, metric in self.metrics:
                if metric is not None:
                    value = float(metric(m, labels, weights))
                else:
                    if host is None:
                        host = self._host_predictions(m)
                    preds, prob_matrix = host
                    value = eval_metrics.evaluate(
                        metric_name, preds, dm.labels, dm.weights, groups=dm.groups,
                        prob_matrix=prob_matrix)
                results.append((name, metric_name, value))
        return results

    def _host_predictions(self, margins):
        """(predictions, class probabilities or None) on the host, for the
        metrics without a device form."""
        margin = margins.cpu().numpy()
        prob_matrix = None
        if self.num_group > 1:
            prob_matrix = SoftprobMulti.margin_to_prediction(self.objective, margin)
        return self.objective.margin_to_prediction(margin), prob_matrix


def train(
    params,
    dtrain,
    num_boost_round=10,
    evals=(),
    device=None,
    callbacks=None,
    verbose_eval=True,
    xgb_model=None,
):
    """Train a Forest on ``device`` (CUDA unless given). API mirrors
    ``xgb.train``: ``evals`` is a list of (DataMatrix, name) pairs whose
    metric lines print each round when ``verbose_eval``. ``xgb_model``, a
    Forest or a model-file path, resumes training: its trees stay, the
    margins start from its predictions, and round numbers continue from its
    last round."""
    dev = resolve_device(device)
    config = TrainConfig(params)
    callbacks = list(callbacks or [])
    if xgb_model is None:
        objective_params = {
            k: v for k, v in config.objective_params.items() if k in OBJECTIVE_PARAM_KEYS
        }
        groups = create_objective(config.objective, objective_params).num_output_group
        forest = Forest(
            objective_name=config.objective,
            objective_params=objective_params,
            base_score=config.base_score,
            num_feature=dtrain.num_col,
            num_class=config.num_class if groups > 1 else 0,
            feature_names=dtrain.feature_names,
            device=dev,
        )
    elif isinstance(xgb_model, Forest):
        forest = xgb_model.to(dev)
    else:
        forest = Forest.load_model(xgb_model, device=dev)
    if forest.num_feature < dtrain.num_col and forest.trees:
        raise exc.UserError("feature_names mismatch between checkpoint and data")
    forest.num_feature = max(forest.num_feature, dtrain.num_col)
    metric_names = _eval_metric_names(config, forest.objective())
    session = _TrainingSession(config, dtrain, list(evals), forest, metric_names, dev)

    for cb in callbacks:
        if hasattr(cb, "before_training"):
            forest = cb.before_training(forest) or forest

    evals_log = {}
    start_round = forest.num_boosted_rounds
    for rnd in range(start_round, start_round + num_boost_round):
        tree_np = session.run_round()
        if session.num_group == 1:
            forest.append_round([compact_padded_tree(tree_np, session.cuts)], [0])
        else:
            forest.append_round(
                [compact_padded_tree({k: v[c] for k, v in tree_np.items()}, session.cuts)
                 for c in range(session.num_group)],
                list(range(session.num_group)),
            )
        results = session.evaluate()
        for data_name, metric_name, value in results:
            evals_log.setdefault(data_name, {}).setdefault(metric_name, []).append(value)
        if verbose_eval and results:
            print(
                "[{}]\t{}".format(
                    rnd, "\t".join("{}-{}:{:.5f}".format(d, m, v) for d, m, v in results)
                ),
                flush=True,
            )
        stops = [
            cb.after_iteration(forest, rnd, evals_log)
            for cb in callbacks
            if hasattr(cb, "after_iteration")
        ]
        if any(stops):
            break

    for cb in callbacks:
        if hasattr(cb, "after_training"):
            forest = cb.after_training(forest) or forest
    return forest
