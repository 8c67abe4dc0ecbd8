"""Objective functions: gradient/hessian pairs on tensors + output transforms.

* ``grad_hess(margin, label, weight)`` -> (g, h) per row, torch tensors
* ``margin_to_prediction(margin)``      -> what ``predict()`` returns (numpy)
* ``base_margin(base_score)``           -> initial margin from base_score

Every objective of xgboost that the container serves is registered, so a
model of any of them loads and predicts. Gradients follow the published
XGBoost objective definitions and exist for ``TRAINABLE`` only; the others
raise ``UserError`` naming the objective when training asks for them.
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


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


class Objective:
    """Base: binary/regression single-output objective."""

    name = None
    num_output_group = 1
    default_metric = "rmse"

    def __init__(self, params=None):
        self.params = params or {}
        self.scale_pos_weight = float(self.params.get("scale_pos_weight", 1.0))

    def grad_hess(self, margin, label, weight):
        raise exc.UserError(
            "Training with objective '{}' is not supported by the PyTorch port yet; "
            "it can only predict with such a model".format(self.name)
        )

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


class PseudoHuber(Objective):
    name = "reg:pseudohubererror"
    default_metric = "mphe"


class AbsoluteError(Objective):
    name = "reg:absoluteerror"
    default_metric = "mae"


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

    def grad_hess(self, margin, label, weight):
        return Objective.grad_hess(self, margin, label, weight)

    def margin_to_prediction(self, margin):
        return margin


class BinaryHinge(Objective):
    name = "binary:hinge"
    default_metric = "error"

    def validate_labels(self, labels):
        if labels.size and ((labels < 0).any() or (labels > 1).any()):
            raise exc.UserError(LOGISTIC_REGRESSION_LABEL_RANGE_ERROR)

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

    def margin_to_prediction(self, margin):
        return np.exp(margin)


class GammaRegression(PoissonRegression):
    name = "reg:gamma"
    default_metric = "gamma-nloglik"

    def validate_labels(self, labels):
        if labels.size and (labels < 0).any():
            raise exc.UserError("label must be nonnegative for gamma regression")


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
    column); the prediction is the event time."""

    name = "survival:aft"
    default_metric = "aft-nloglik"

    def validate_labels(self, labels):
        if labels.size and (labels <= 0).any():
            raise exc.UserError("survival:aft labels (event times) must be positive")

    def base_margin(self, base_score):
        return math.log(max(float(base_score), 1e-16))

    def margin_to_prediction(self, margin):
        return np.exp(margin)


class SurvivalCox(Objective):
    """survival:cox; the prediction is the hazard ratio."""

    name = "survival:cox"
    default_metric = "cox-nloglik"

    def base_margin(self, base_score):
        return 0.0

    def margin_to_prediction(self, margin):
        return np.exp(margin)


class RankPairwise(Objective):
    """rank:pairwise / rank:ndcg / rank:map; the prediction is the margin."""

    name = "rank:pairwise"
    default_metric = "map"


class RankNdcg(RankPairwise):
    name = "rank:ndcg"
    default_metric = "ndcg"


class RankMap(RankPairwise):
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
        RankPairwise,
        RankNdcg,
        RankMap,
    ]
}
_REGISTRY["reg:linear"] = SquaredError  # deprecated alias

# the objectives whose gradients the port computes
TRAINABLE = ("reg:squarederror", "reg:linear", "reg:logistic", "binary:logistic")


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
