"""gblinear booster: an elastic-net linear model trained by coordinate
descent, one sweep over the features a boosting round.

The port's counterpart of ``sagemaker_xgboost_container_tpu/models/gblinear.py``
(xgboost's ``coord_descent`` updater): each round computes the objective's
grad/hess once at the current margins, then updates the features one after
another, each from the gradient left by the features before it
(``g += h * x_j * delta``), with L2 (``lambda``), L1 (``alpha``, a soft
threshold) and ``eta`` shrinkage, and last the bias (``lambda_bias``).
Missing values count as 0.

On the device the sweep is a Python loop of torch ops over the columns of
``x^T`` (a dozen launches a feature); ``x @ w`` is one ``torch.matmul``. The
hessian sums of every feature, ``x_j^2 . h``, do not change within a round,
so they are one matmul before the sweep, where the JAX package takes them
feature by feature inside its ``lax.scan``.

Across ranks (``group``), the JAX package's gblinear on a data mesh: each
rank holds its own rows, and every sum over rows is all-reduced over the
group, so every rank makes the same weight updates. The hessian sums of all
features go in one all-reduce a round, since they do not change within it;
each feature step's ``x_j . g`` in one small all-reduce (the sweep is
sequential: a step reads the gradient that the step before it left); the
bias's (sum g, sum h) in one. ``survival:cox`` computes its gradients on the
gathered global rows (``booster.GlobalRows``).

Model format: xgboost gblinear JSON, byte for byte the JAX package's
``LinearModel.save_json`` (weights feature-major, then the per-group bias).
"""

import json
import logging
import threading

import numpy as np
import torch

from .._device import resolve_device
from ..telemetry import tracing
from . import objectives as objectives_mod
from .forest import _count_predict, _host_predict_rows, _parse_base_score

logger = logging.getLogger(__name__)

# objective parameters a trained linear model keeps (the JAX package's)
_LINEAR_PARAM_KEYS = ("scale_pos_weight", "num_class", "lambda_bias")


class LinearModel:
    """A gblinear model: host weights [d, G] and bias [G], with the Forest
    interface the serving and training planes use (``predict``,
    ``predict_margin``, ``objective()``, ``num_output_group``,
    ``num_boosted_rounds``, ``attr``/``set_attr``, ``save_model``, ``to``,
    ``release``). ``device``: where ``predict`` runs payloads of more than
    ``_host_predict_rows()`` rows (CUDA unless given; raises when CUDA is asked
    for and absent)."""

    def __init__(self, weights, bias, objective_name, base_score, num_feature, num_class=0,
                 objective_params=None, device=None):
        self.weights = np.asarray(weights, np.float32)
        self.bias = np.asarray(bias, np.float32)
        self.objective_name = objective_name
        self.objective_params = dict(objective_params or {})
        self.base_score = float(base_score)
        self.num_feature = int(num_feature)
        self.num_class = int(num_class)
        self.attributes = {}
        self.rounds = 0
        self.device = resolve_device(device)
        self._dev = None  # (weights, bias) on the device, uploaded at first use
        self._dev_lock = threading.Lock()

    def to(self, device):
        """Predict on ``device`` from now on; returns self."""
        with self._dev_lock:
            self.device = resolve_device(device)
            self._dev = None
        return self

    def release(self):
        """Drop the device copy of the weights; a later predict uploads them
        again."""
        with self._dev_lock:
            self._dev = None

    def _device_weights(self):
        with self._dev_lock:
            if self._dev is None:
                self._dev = (torch.as_tensor(self.weights, device=self.device),
                             torch.as_tensor(self.bias, device=self.device))
            return self._dev

    @property
    def num_output_group(self):
        return max(1, self.num_class)

    @property
    def num_boosted_rounds(self):
        return self.rounds

    def objective(self):
        params = dict(self.objective_params)
        if self.num_class:
            params.setdefault("num_class", self.num_class)
        return objectives_mod.create_objective(self.objective_name, params)

    def attr(self, key):
        return self.attributes.get(key)

    def set_attr(self, **kwargs):
        for key, value in kwargs.items():
            if value is None:
                self.attributes.pop(key, None)
            else:
                self.attributes[key] = str(value)

    def predict_margin(self, features, iteration_range=None):
        """features [n, d] (numpy or tensor, NaN = 0) -> numpy margins, [n]
        or [n, G]. Columns beyond ``num_feature`` are dropped, missing ones
        are 0. ``iteration_range`` is accepted and ignored (a linear model
        has no rounds to slice), as in the JAX package."""
        base = self.objective().base_margin(self.base_score)
        n = features.shape[0]
        if 0 < n <= _host_predict_rows() or self.num_feature == 0:
            _count_predict("host")
            if isinstance(features, torch.Tensor):
                features = features.cpu().numpy()
            x = _fit_width(np.nan_to_num(np.asarray(features, np.float32), nan=0.0),
                           self.num_feature)
            margin = x @ self.weights + self.bias[None, :] + base
        else:
            _count_predict("device")
            w, b = self._device_weights()
            x = torch.as_tensor(features, dtype=torch.float32, device=self.device)
            x = _fit_width(torch.nan_to_num(x, nan=0.0), self.num_feature)
            margin = (x @ w + b[None, :] + base).cpu().numpy()
            tracing.device_sync(self.device)
        return margin[:, 0] if self.num_output_group == 1 else margin

    def predict(self, features, output_margin=False, iteration_range=None):
        margin = self.predict_margin(features)
        if output_margin:
            return margin
        return self.objective().margin_to_prediction(margin)

    # ------------------------------------------------------------------ json
    def save_json(self):
        G = self.num_output_group
        flat = []
        for f in range(self.num_feature):
            flat.extend(float(self.weights[f, g]) for g in range(G))
        flat.extend(float(b) for b in self.bias)
        attributes = dict(self.attributes)
        attributes.setdefault("num_boosted_rounds", str(self.rounds))
        doc = {
            "version": [3, 0, 0],
            "learner": {
                "attributes": attributes,
                "feature_names": [],
                "feature_types": [],
                "gradient_booster": {
                    "model": {"param": {}, "weights": flat},
                    "name": "gblinear",
                },
                "learner_model_param": {
                    "base_score": repr(self.base_score),
                    "num_class": str(self.num_class),
                    "num_feature": str(self.num_feature),
                    "num_target": "1",
                },
                "objective": {"name": self.objective_name},
            },
        }
        return json.dumps(doc)

    def save_model(self, path):
        with open(path, "w") as f:
            f.write(self.save_json())

    @classmethod
    def from_dict(cls, doc, device=None):
        learner = doc["learner"]
        lmp = learner["learner_model_param"]
        num_feature = int(lmp.get("num_feature", 0))
        num_class = int(lmp.get("num_class", 0))
        G = max(1, num_class)
        flat = np.asarray(learner["gradient_booster"]["model"]["weights"], np.float32)
        model = cls(
            flat[: num_feature * G].reshape(num_feature, G),
            flat[num_feature * G: num_feature * G + G],
            objective_name=learner["objective"]["name"],
            base_score=_parse_base_score(lmp.get("base_score", 0.5)),
            num_feature=num_feature,
            num_class=num_class,
            device=device,
        )
        model.attributes = dict(learner.get("attributes", {}))
        try:
            model.rounds = int(model.attributes.pop("num_boosted_rounds", 0))
        except (TypeError, ValueError):
            model.rounds = 0
        return model


def _fit_width(x, d):
    """Zero-pad or cut the columns of ``x`` (numpy or tensor) to ``d``."""
    have = x.shape[1]
    if have > d:
        return x[:, :d]
    if have < d:
        if isinstance(x, torch.Tensor):
            return torch.nn.functional.pad(x, (0, d - have))
        return np.pad(x, ((0, 0), (0, d - have)))
    return x


def train_linear(config, dtrain, num_boost_round, evals=(), feval=None, callbacks=None,
                 initial_model=None, device=None, verbose_eval=True, group=None):
    """Train a LinearModel on ``device``; the loop contract of
    ``booster.train`` (callbacks, metric lines, absolute round numbers).
    ``initial_model``: a LinearModel to continue from (checkpoint resume).
    ``group``: the process group of data-parallel training, or None."""
    from ..parallel import collectives
    from .booster import GlobalRows, _eval_metric_names, evaluate_host_lines, print_metric_line

    dev = resolve_device(device)
    callbacks = list(callbacks or [])
    objective = objectives_mod.create_objective(config.objective, config.objective_params)
    objective.validate_labels(dtrain.labels)
    G = objective.num_output_group
    d = dtrain.num_col

    def on_device(features):
        # missing = 0 on the linear path
        return torch.nan_to_num(torch.as_tensor(features, dtype=torch.float32, device=dev),
                                nan=0.0)

    x = on_device(dtrain.features)
    xT = x.T.contiguous()
    xT_sq = xT * xT
    labels = torch.as_tensor(dtrain.labels, device=dev)
    weights_row = torch.as_tensor(dtrain.get_weight(), device=dev)
    eval_x = [x if dm is dtrain else on_device(dm.features) for dm, _name in evals]
    base = objective.base_margin(config.base_score)
    lam, alpha, eta = config.reg_lambda, config.alpha, config.eta
    lambda_bias = float(config.objective_params.get("lambda_bias", 0.0))
    global_rows = None
    if group is not None and config.objective == "survival:cox":
        global_rows = GlobalRows(dtrain.labels, dtrain.get_weight(), group, dev)

    def allsum(t):
        return collectives.all_reduce(t, group, kind="linear")

    if initial_model is not None:
        w = torch.as_tensor(initial_model.weights.reshape(d, G), device=dev).clone()
        b = torch.as_tensor(initial_model.bias.reshape(G), device=dev).clone()
        start_round = initial_model.num_boosted_rounds
    else:
        w = torch.zeros((d, G), dtype=torch.float32, device=dev)
        b = torch.zeros(G, dtype=torch.float32, device=dev)
        start_round = 0

    def one_round():
        margins = x @ w + b[None, :] + base
        margins = margins[:, 0] if G == 1 else margins
        if global_rows is not None:
            g, h = global_rows.grad_hess(objective, margins)
        else:
            g, h = objective.grad_hess(margins, labels, weights_row)
        # [G, n]: each feature's step reads and updates contiguous rows
        gT = (g[None] if G == 1 else g.T).contiguous()
        hT = (h[None] if G == 1 else h.T).contiguous()
        hw = allsum(torch.matmul(xT_sq, hT.T)) + lam    # [d, G], fixed for the round
        shrink = alpha / hw
        for j in range(d):
            w_j = w[j]
            if group is None:
                gw = torch.addmv(w_j, gT, xT[j], beta=lam)   # x_j . g + lambda * w_j
            else:
                gw = allsum(torch.mv(gT, xT[j])) + lam * w_j
            raw = w_j - gw / hw[j]
            new_w = torch.sign(raw) * torch.clamp_min(raw.abs() - shrink[j], 0.0)
            delta = eta * (new_w - w_j)
            gT.addcmul_(hT * xT[j], delta[:, None])
            w_j += delta
        gh = allsum(torch.stack([gT.sum(dim=1), hT.sum(dim=1)]))
        gb = gh[0] + lambda_bias * b
        hb = gh[1] + lambda_bias
        b.sub_(eta * gb / torch.clamp_min(hb, 1e-6))

    model = LinearModel(
        np.zeros((d, G)), np.zeros(G),
        objective_name=config.objective,
        base_score=config.base_score,
        num_feature=d,
        num_class=config.num_class,
        objective_params={k: v for k, v in config.objective_params.items()
                          if k in _LINEAR_PARAM_KEYS},
        device=dev,
    )
    metric_names = _eval_metric_names(config, objective)
    model.rounds = start_round
    evals_log = {}
    rows_cache = {}   # eval entry -> its global rows (cox-nloglik across ranks)
    for cb in callbacks:
        if hasattr(cb, "before_training"):
            model = cb.before_training(model) or model
    for rnd in range(start_round, start_round + num_boost_round):
        one_round()
        model.weights = w.cpu().numpy().copy()
        model.bias = b.cpu().numpy().copy()
        model.rounds = rnd + 1
        model.release()
        entries = []
        for (dm, name), xe in zip(evals, eval_x):
            margin = (xe @ w + b[None, :] + base).cpu().numpy()
            entries.append((name, dm, margin[:, 0] if G == 1 else margin))
        results = evaluate_host_lines(entries, metric_names, feval, objective, G, group=group,
                                      device=dev, objective_params=config.objective_params,
                                      rows_cache=rows_cache)
        for data_name, metric_name, value in results:
            evals_log.setdefault(data_name, {}).setdefault(metric_name, []).append(value)
        if verbose_eval:
            print_metric_line(rnd, results)
        stops = [cb.after_iteration(model, rnd, evals_log)
                 for cb in callbacks if hasattr(cb, "after_iteration")]
        if any(stops):
            break
    for cb in callbacks:
        if hasattr(cb, "after_training"):
            model = cb.after_training(model) or model
    return model
