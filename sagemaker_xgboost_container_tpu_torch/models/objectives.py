"""Objective functions: gradient/hessian pairs on tensors + output transforms.

* ``grad_hess(margin, label, weight)`` -> (g, h) per row, torch tensors
* ``margin_to_prediction(margin)``      -> what ``predict()`` returns (numpy)
* ``base_margin(base_score)``           -> initial margin from base_score

Every objective of xgboost that the container serves is registered, so a
model of any of them loads and predicts. Gradients follow the published
XGBoost objective definitions (the JAX package's formulas, elementwise).
Every registered objective trains (``TRAINABLE``): the ranking ones need
query groups, so their ``grad_hess`` raises and the booster computes their
gradients with ``ops.ranking.lambdarank_grad_hess`` over the group layout.
"""

import math

import numpy as np
import torch

from ..constants import (
    LOGISTIC_REGRESSION_LABEL_RANGE_ERROR,
    MULTI_CLASS_LABEL_RANGE_ERROR,
    POISSON_REGRESSION_ERROR,
    TWEEDIE_REGRESSION_ERROR,
)
from ..toolkit import exceptions as exc

_EPS = 1e-16
_HESS_EPS = 1e-6


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


class Objective:
    """Base: binary/regression single-output objective."""

    name = None
    num_output_group = 1
    default_metric = "rmse"
    needs_groups = False

    def __init__(self, params=None):
        self.params = params or {}
        self.scale_pos_weight = float(self.params.get("scale_pos_weight", 1.0))

    def grad_hess(self, margin, label, weight):
        raise NotImplementedError

    def validate_labels(self, labels):
        pass

    def base_margin(self, base_score):
        return float(base_score)

    def margin_to_prediction(self, margin):
        return margin


class SquaredError(Objective):
    name = "reg:squarederror"

    def grad_hess(self, margin, label, weight):
        return (margin - label) * weight, torch.ones_like(margin) * weight


class SquaredLogError(Objective):
    name = "reg:squaredlogerror"
    default_metric = "rmsle"

    def grad_hess(self, margin, label, weight):
        p = torch.clamp(margin, min=-1 + 1e-6)
        z = torch.log1p(p) - torch.log1p(label)
        g = z / (p + 1.0)
        h = torch.clamp((1.0 - z) / ((p + 1.0) ** 2), min=_HESS_EPS)
        return g * weight, h * weight


class PseudoHuber(Objective):
    name = "reg:pseudohubererror"
    default_metric = "mphe"

    def grad_hess(self, margin, label, weight):
        delta = float(self.params.get("huber_slope", 1.0))
        z = margin - label
        scale = torch.sqrt(1.0 + (z / delta) ** 2)
        g = z / scale
        h = 1.0 / (scale**3)
        return g * weight, h * weight


class AbsoluteError(Objective):
    name = "reg:absoluteerror"
    default_metric = "mae"

    def grad_hess(self, margin, label, weight):
        return torch.sign(margin - label) * weight, torch.ones_like(margin) * weight


class LogisticRegression(Objective):
    """reg:logistic — logistic loss, label in [0,1], prediction is probability."""

    name = "reg:logistic"
    default_metric = "rmse"

    def validate_labels(self, labels):
        if labels.size and ((labels < 0).any() or (labels > 1).any()):
            raise exc.UserError(LOGISTIC_REGRESSION_LABEL_RANGE_ERROR)

    def base_margin(self, base_score):
        base_score = float(base_score)
        if not 0.0 < base_score < 1.0:
            raise exc.UserError("base_score must be in (0,1) for logistic loss")
        return math.log(base_score / (1.0 - base_score))

    def grad_hess(self, margin, label, weight):
        p = _sigmoid(margin)
        w = torch.where(label == 1.0, weight * self.scale_pos_weight, weight)
        g = (p - label) * w
        h = torch.clamp(p * (1.0 - p), min=_EPS) * w
        return g, h

    def margin_to_prediction(self, margin):
        return 1.0 / (1.0 + np.exp(-margin))


class BinaryLogistic(LogisticRegression):
    name = "binary:logistic"
    default_metric = "logloss"


class BinaryLogitRaw(LogisticRegression):
    """binary:logitraw — logistic loss, the raw margin as prediction."""

    name = "binary:logitraw"
    default_metric = "logloss"

    def margin_to_prediction(self, margin):
        return margin


class BinaryHinge(Objective):
    name = "binary:hinge"
    default_metric = "error"

    def validate_labels(self, labels):
        if labels.size and ((labels < 0).any() or (labels > 1).any()):
            raise exc.UserError(LOGISTIC_REGRESSION_LABEL_RANGE_ERROR)

    def grad_hess(self, margin, label, weight):
        y = 2.0 * label - 1.0
        in_margin = margin * y < 1.0
        g = torch.where(in_margin, -y, 0.0) * weight
        h = torch.where(in_margin, 1.0, _HESS_EPS) * weight
        return g, h

    def margin_to_prediction(self, margin):
        return (margin > 0).astype(np.float32)


class PoissonRegression(Objective):
    name = "count:poisson"
    default_metric = "poisson-nloglik"

    def validate_labels(self, labels):
        if labels.size and (labels < 0).any():
            raise exc.UserError(POISSON_REGRESSION_ERROR)

    def base_margin(self, base_score):
        return math.log(max(float(base_score), 1e-16))

    def grad_hess(self, margin, label, weight):
        p = torch.exp(margin)
        return (p - label) * weight, p * weight

    def margin_to_prediction(self, margin):
        return np.exp(margin)


class GammaRegression(PoissonRegression):
    name = "reg:gamma"
    default_metric = "gamma-nloglik"

    def validate_labels(self, labels):
        if labels.size and (labels < 0).any():
            raise exc.UserError("label must be nonnegative for gamma regression")

    def grad_hess(self, margin, label, weight):
        ey = label * torch.exp(-margin)
        return (1.0 - ey) * weight, torch.clamp(ey, min=_HESS_EPS) * weight


class TweedieRegression(PoissonRegression):
    name = "reg:tweedie"

    def __init__(self, params=None):
        super().__init__(params)
        self.rho = float(self.params.get("tweedie_variance_power", 1.5))

    @property
    def default_metric(self):  # noqa: A003 - xgboost's default names the power
        return "tweedie-nloglik@{}".format(self.rho)

    def validate_labels(self, labels):
        if labels.size and (labels < 0).any():
            raise exc.UserError(TWEEDIE_REGRESSION_ERROR)

    def grad_hess(self, margin, label, weight):
        rho = self.rho
        a = label * torch.exp((1.0 - rho) * margin)
        b = torch.exp((2.0 - rho) * margin)
        g = (-a + b) * weight
        h = torch.clamp(-a * (1.0 - rho) + b * (2.0 - rho), min=_HESS_EPS) * weight
        return g, h


class SoftmaxMulti(Objective):
    """multi:softmax / multi:softprob — the margin is [n, num_class]."""

    name = "multi:softmax"
    default_metric = "merror"

    def __init__(self, params=None):
        super().__init__(params)
        self.num_class = int(self.params.get("num_class", 0))
        if self.num_class < 2:
            raise exc.UserError(
                "Require input for parameter 'num_class' for multi-classification"
            )
        self.num_output_group = self.num_class

    def validate_labels(self, labels):
        if labels.size and ((labels < 0).any() or (labels >= self.num_class).any()):
            raise exc.UserError(MULTI_CLASS_LABEL_RANGE_ERROR)

    def base_margin(self, base_score):
        return 0.5

    def grad_hess(self, margin, label, weight):
        # margin [n, C]; label, weight [n]
        p = torch.exp(margin - torch.amax(margin, dim=1, keepdim=True))
        p = p / torch.sum(p, dim=1, keepdim=True)
        classes = torch.arange(p.shape[1], device=p.device)
        onehot = (label[:, None] == classes[None, :]).to(p.dtype)
        g = (p - onehot) * weight[:, None]
        h = torch.clamp(2.0 * p * (1.0 - p), min=_EPS) * weight[:, None]
        return g, h

    def margin_to_prediction(self, margin):
        return np.argmax(margin, axis=1).astype(np.float32)


class SoftprobMulti(SoftmaxMulti):
    name = "multi:softprob"
    default_metric = "mlogloss"

    def margin_to_prediction(self, margin):
        e = np.exp(margin - margin.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)


class SurvivalAft(Objective):
    """survival:aft with point labels (the SageMaker data carries one label
    column, so the censoring interval is [label, label]); the prediction is
    the event time. ``aft_loss_distribution`` is normal, logistic or
    extreme, scaled by ``aft_loss_distribution_scale``."""

    name = "survival:aft"
    default_metric = "aft-nloglik"

    def __init__(self, params=None):
        super().__init__(params)
        self.dist = str(self.params.get("aft_loss_distribution", "normal"))
        self.sigma = float(self.params.get("aft_loss_distribution_scale", 1.0))

    def grad_hess(self, margin, label, weight):
        s = self.sigma
        z = (torch.log(torch.clamp(label, min=1e-12)) - margin) / s
        if self.dist == "normal":
            g = -z / s
            h = torch.full_like(margin, 1.0 / (s * s))
        elif self.dist == "logistic":
            ez = torch.exp(-torch.abs(z))
            sig = torch.where(z >= 0, 1.0 / (1.0 + ez), ez / (1.0 + ez))
            g = -(2.0 * sig - 1.0) / s
            h = torch.clamp(2.0 * sig * (1.0 - sig) / (s * s), min=_HESS_EPS)
        else:  # extreme (Gumbel)
            w = torch.exp(torch.clamp(z, -30.0, 30.0))
            g = (1.0 - w) / s
            h = torch.clamp(w / (s * s), min=_HESS_EPS)
        return g * weight, h * weight

    def validate_labels(self, labels):
        if labels.size and (labels <= 0).any():
            raise exc.UserError("survival:aft labels (event times) must be positive")

    def base_margin(self, base_score):
        return math.log(max(float(base_score), 1e-16))

    def margin_to_prediction(self, margin):
        return np.exp(margin)


class SurvivalCox(Objective):
    """survival:cox, the proportional-hazards partial likelihood; the
    prediction is the hazard ratio. Labels follow xgboost: positive = event
    time, negative = |censoring time|. Risk sets are cumulative sums over
    the rows in descending |label| (a stable sort, ties in row order), an
    order taken once per label tensor: the labels do not change between
    rounds."""

    name = "survival:cox"
    default_metric = "cox-nloglik"

    def __init__(self, params=None):
        super().__init__(params)
        self._order = None  # (label tensor, order, inverse order)

    def base_margin(self, base_score):
        return 0.0

    def _risk_order(self, label):
        if self._order is None or self._order[0] is not label:
            order = torch.argsort(-torch.abs(label), stable=True)
            inv = torch.empty_like(order)
            inv[order] = torch.arange(order.numel(), device=order.device)
            self._order = (label, order, inv)
        return self._order[1], self._order[2]

    def grad_hess(self, margin, label, weight):
        order, inv = self._risk_order(label)
        is_event = (label > 0).to(margin.dtype)
        exp_m = torch.exp(margin - torch.max(margin)) * weight
        cum_risk = torch.cumsum(exp_m[order], 0)           # risk set of order[k]
        # over events e with t_e <= t_i: sums of 1/risk(e) and 1/risk(e)^2
        ev = (is_event * weight)[order]
        cum_inv = torch.flip(torch.cumsum(torch.flip(ev / cum_risk, [0]), 0), [0])[inv]
        cum_inv2 = torch.flip(
            torch.cumsum(torch.flip(ev / cum_risk**2, [0]), 0), [0])[inv]
        g = -is_event * weight + exp_m * cum_inv
        h = torch.clamp(exp_m * cum_inv - (exp_m**2) * cum_inv2, min=_HESS_EPS)
        return g, h

    def margin_to_prediction(self, margin):
        return np.exp(margin)


class LambdaRankObjective(Objective):
    """rank:pairwise / rank:ndcg / rank:map: LambdaMART gradients; the
    prediction is the margin.

    Gradients need the query-group layout, so the booster routes these
    through ``ops.ranking.lambdarank_grad_hess``; this class carries the
    scheme (the part of the name after ``rank:``)."""

    name = "rank:pairwise"
    default_metric = "map"
    needs_groups = True

    def __init__(self, params=None):
        super().__init__(params)
        self.scheme = self.name.split(":")[1]

    def grad_hess(self, margin, label, weight):
        raise exc.AlgorithmError(
            "ranking objectives need group info; the booster must route through "
            "ops.ranking.lambdarank_grad_hess"
        )


class RankNdcg(LambdaRankObjective):
    name = "rank:ndcg"
    default_metric = "ndcg"


class RankMap(LambdaRankObjective):
    name = "rank:map"
    default_metric = "map"


_REGISTRY = {
    cls.name: cls
    for cls in [
        SquaredError,
        SquaredLogError,
        PseudoHuber,
        AbsoluteError,
        LogisticRegression,
        BinaryLogistic,
        BinaryLogitRaw,
        BinaryHinge,
        PoissonRegression,
        GammaRegression,
        TweedieRegression,
        SoftmaxMulti,
        SoftprobMulti,
        SurvivalAft,
        SurvivalCox,
        LambdaRankObjective,
        RankNdcg,
        RankMap,
    ]
}
_REGISTRY["reg:linear"] = SquaredError  # deprecated alias

# the objectives the port trains: every registered one
TRAINABLE = tuple(sorted(_REGISTRY))


def create_objective(name, params=None):
    """Instantiate an objective by its xgboost name."""
    name = name or "reg:squarederror"
    cls = _REGISTRY.get(name)
    if cls is None:
        raise exc.UserError(
            "Objective '{}' is not supported yet. Supported: {}".format(
                name, ", ".join(sorted(_REGISTRY))
            )
        )
    return cls(params)


def default_base_score(name):
    """XGBoost's default base_score is 0.5 for every objective family."""
    return 0.5
