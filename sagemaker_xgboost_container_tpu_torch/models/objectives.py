"""Objective functions: gradient/hessian pairs on tensors + output transforms.

* ``grad_hess(margin, label, weight)`` -> (g, h) per row, torch tensors
* ``margin_to_prediction(margin)``      -> what ``predict()`` returns (numpy)
* ``base_margin(base_score)``           -> initial margin from base_score

Gradient formulas follow the published XGBoost objective definitions. Only
the objectives of the ported slice are registered.
"""

import math

import numpy as np
import torch

from ..toolkit import exceptions as exc

_EPS = 1e-16
LOGISTIC_REGRESSION_LABEL_RANGE_ERROR = "label must be in [0,1] for logistic regression"


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


class Objective:
    """Base: binary/regression single-output objective."""

    name = None
    default_metric = "rmse"

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


_REGISTRY = {cls.name: cls for cls in [SquaredError, LogisticRegression, BinaryLogistic]}


def create_objective(name, params=None):
    """Instantiate an objective by its xgboost name."""
    name = name or "reg:squarederror"
    cls = _REGISTRY.get(name)
    if cls is None:
        raise exc.UserError(
            "Objective '{}' is not supported by the PyTorch port yet. "
            "Supported: {}".format(name, ", ".join(sorted(_REGISTRY)))
        )
    return cls(params)


def default_base_score(name):
    """XGBoost's default base_score is 0.5 for every objective family."""
    return 0.5
