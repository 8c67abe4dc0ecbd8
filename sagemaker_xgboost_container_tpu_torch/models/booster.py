"""The boosting engine: ``train()``, the counterpart of ``xgb.train``.

One device, eager PyTorch: each round computes the objective's grad/hess,
grows one tree (``ops/tree_build.build_tree``), adds the tree's row outputs
to the training margins and its predictions to every eval set's margins,
evaluates the eval metrics on the device, and commits the compacted tree to
the Forest. The only host work per round is pulling the tree's small node
arrays and the metric scalars.

Callback protocol mirrors xgboost's (before_training / after_iteration ->
bool stop / after_training), which is how early stopping hooks in.
"""

import numpy as np
import torch

from .._device import resolve_device
from ..data.binning import bin_matrix
from ..ops.predict import forest_leaf_values
from ..ops.tree_build import build_tree, pack_tree, predict_binned, unpack_tree
from ..toolkit import exceptions as exc
from .device_metrics import make_device_metric
from .forest import Forest, compact_padded_tree
from .objectives import TRAINABLE

# objective hyperparameters carried into the saved model
OBJECTIVE_PARAM_KEYS = ("scale_pos_weight", "max_delta_step")
# trees traversed together when a resumed run rebuilds its margins
_RESUME_TREES_PER_PASS = 64


class TrainConfig:
    """Parsed + defaulted booster parameters of the ported slice.

    Takes every key that ``algorithm.hyperparameters`` validates. Keys that
    do not change a depthwise gbtree model (``updater``, ``predictor``,
    ``nthread``, ``verbosity``, ``seed``, the dart and gblinear knobs, ...)
    are accepted and ignored, as the JAX package ignores them there.
    Everything the slice does not run raises ``UserError`` naming the
    parameter, rather than training something else.
    """

    def __init__(self, params):
        p = dict(params or {})
        self.eta = float(p.get("eta", 0.3))
        max_depth = p.get("max_depth", 6)
        self.max_depth = int(max_depth) if max_depth is not None else 6
        if self.max_depth < 1:
            raise exc.UserError("max_depth must be >= 1 for grow_policy='depthwise'")
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
        self.base_score = float(p.get("base_score", 0.5))
        self.eval_metric = p.get("eval_metric")
        self.objective_params = p

        unsupported = []
        if self.objective not in TRAINABLE:
            unsupported.append("objective={!r}".format(self.objective))
        for key in ("subsample", "colsample_bytree", "colsample_bylevel", "colsample_bynode"):
            if float(p.get(key, 1.0)) < 1.0:
                unsupported.append("{}={}".format(key, p[key]))
        checks = (
            ("grow_policy", "depthwise", lambda v: v == "depthwise"),
            ("tree_method", "auto", lambda v: v in ("auto", "hist")),
            ("booster", "gbtree", lambda v: v == "gbtree"),
            ("num_class", 0, lambda v: int(v or 0) <= 1),
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
        base = self.objective.base_margin(forest.base_score)
        self.margins = self._start_margins(forest, dtrain, base)

        self.metrics = []
        for name in metric_names:
            m = make_device_metric(name, self.objective.name)
            if m is None:
                raise exc.UserError(
                    "eval_metric {!r} is not supported by the PyTorch port yet".format(name)
                )
            self.metrics.append(m)

        # eval sets: bins and labels on the device once, margins incremental;
        # the training matrix itself shares the training margins
        self.eval_sets = []
        for dm, name in evals:
            if dm is dtrain:
                self.eval_sets.append((name, None, self.labels, self.weights, None))
                continue
            binned = bin_matrix(dm, config.max_bin, cut_points=self.cuts)
            self.eval_sets.append((
                name,
                torch.as_tensor(binned.bins, device=device),
                torch.as_tensor(dm.labels, device=device),
                torch.as_tensor(dm.get_weight(), device=device),
                self._start_margins(forest, dm, base),
            ))

    def _start_margins(self, forest, dm, base):
        """Margins of ``dm``'s rows before the first new round: the base
        margin plus the resumed forest's trees, added one tree at a time in
        round order as the rounds added them, so that a resumed run's
        margins equal an uninterrupted run's bit for bit."""
        margins = torch.full((dm.num_row,), base, dtype=torch.float32, device=self.device)
        if forest.trees:
            x = torch.as_tensor(dm.features, device=self.device)
            for lo in range(0, len(forest.trees), _RESUME_TREES_PER_PASS):
                hi = min(lo + _RESUME_TREES_PER_PASS, len(forest.trees))
                _, stacked = forest._stack(lo, hi)
                for leaf in forest_leaf_values(stacked, x).unbind(1):
                    margins += leaf
        return margins

    def run_round(self):
        """Grow one tree and update every margin -> host tree dict."""
        cfg = self.config
        g, h = self.objective.grad_hess(self.margins, self.labels, self.weights)
        tree, row_out = build_tree(
            self.bins, g, h, self.num_cuts,
            max_depth=cfg.max_depth, num_bins=self.num_bins,
            reg_lambda=cfg.reg_lambda, alpha=cfg.alpha, gamma=cfg.gamma,
            min_child_weight=cfg.min_child_weight, eta=cfg.eta,
            max_delta_step=cfg.max_delta_step,
        )
        self.margins += row_out
        for _name, bins, _labels, _weights, margins in self.eval_sets:
            if bins is not None:
                margins += predict_binned(tree, bins, cfg.max_depth, self.num_bins)
        return unpack_tree(pack_tree(tree))

    def evaluate(self):
        """-> list of (data_name, metric_name, value) per eval set."""
        results = []
        for name, _bins, labels, weights, margins in self.eval_sets:
            m = self.margins if margins is None else margins
            for metric in self.metrics:
                results.append((name, metric.name, float(metric(m, labels, weights))))
        return results


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
        forest = Forest(
            objective_name=config.objective,
            objective_params={
                k: v for k, v in config.objective_params.items() if k in OBJECTIVE_PARAM_KEYS
            },
            base_score=config.base_score,
            num_feature=dtrain.num_col,
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
        forest.append_round([compact_padded_tree(tree_np, session.cuts)], [0])
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
