"""sklearn-style estimators over the port's ``train()``.

``TorchXGBRegressor``, ``TorchXGBClassifier`` and ``TorchXGBRanker`` are the
counterparts of the JAX package's ``TPUXGBRegressor``, ``TPUXGBClassifier``
and ``TPUXGBRanker`` (``sagemaker_xgboost_container_tpu/sklearn.py``): the
same parameters and renames (``reg_lambda`` -> ``lambda``, ``reg_alpha`` ->
``alpha``), ``fit`` / ``predict`` / ``predict_proba`` / ``score``,
``get_booster``, ``save_model`` and ``feature_importances_`` (normalized
gain), for user scripts written against xgboost's sklearn API. ``device``
says where they train and predict: CUDA unless given, like every entry
point of the port.

The module imports and works without sklearn: ``score`` computes R^2 and
accuracy in numpy. sklearn's estimator protocol is met by duck typing
instead of by inheritance: ``get_params`` / ``set_params`` (what
``sklearn.base.clone`` calls) and ``__sklearn_tags__``, which imports
``sklearn.utils`` only when sklearn itself asks for the tags (``clone``,
``cross_val_score`` and ``is_classifier`` do), so sklearn loads only in a
process that already uses it.
"""

import numpy as np

from .data.matrix import DataMatrix
from .models.booster import train as _train

_RENAMES = {"reg_lambda": "lambda", "reg_alpha": "alpha"}


class _BaseEstimator:
    _objective = "reg:squarederror"
    _estimator_type = None

    def __init__(self, n_estimators=100, objective=None, device=None, **params):
        self.n_estimators = n_estimators
        self.objective = objective or self._objective
        self.device = device
        self.params = params
        self._model = None

    # -- sklearn protocol ----------------------------------------------------
    def get_params(self, deep=True):
        out = {"n_estimators": self.n_estimators, "objective": self.objective,
               "device": self.device}
        out.update(self.params)
        return out

    def set_params(self, **params):
        self.n_estimators = params.pop("n_estimators", self.n_estimators)
        self.objective = params.pop("objective", self.objective)
        self.device = params.pop("device", self.device)
        self.params.update(params)
        return self

    def __sklearn_tags__(self):
        from sklearn.utils import ClassifierTags, RegressorTags, Tags, TargetTags

        kind = self._estimator_type
        return Tags(
            estimator_type=kind,
            target_tags=TargetTags(required=True),
            classifier_tags=ClassifierTags() if kind == "classifier" else None,
            regressor_tags=RegressorTags() if kind == "regressor" else None,
        )

    # -- training ------------------------------------------------------------
    def _train_params(self):
        cfg = {"objective": self.objective}
        for key, value in self.params.items():
            cfg[_RENAMES.get(key, key)] = value
        return cfg

    def _fit(self, dtrain, evals=()):
        self._model = _train(self._train_params(), dtrain, num_boost_round=self.n_estimators,
                             evals=list(evals), device=self.device)
        return self

    def fit(self, X, y, sample_weight=None, eval_set=None, verbose=False):
        dtrain = DataMatrix(np.asarray(X, np.float32), labels=np.asarray(y, np.float32),
                            weights=sample_weight)
        evals = [(DataMatrix(np.asarray(Xv, np.float32), labels=np.asarray(yv, np.float32)),
                  "validation_{}".format(i))
                 for i, (Xv, yv) in enumerate(eval_set or ())]
        return self._fit(dtrain, evals)

    def _check_fitted(self):
        if self._model is None:
            raise RuntimeError("Estimator is not fitted yet; call fit() first")

    def _predict(self, X):
        self._check_fitted()
        return np.asarray(self._model.predict(np.asarray(X, np.float32)))

    @property
    def booster_(self):
        self._check_fitted()
        return self._model

    def get_booster(self):
        return self.booster_

    def save_model(self, path):
        self.booster_.save_model(path)

    @property
    def feature_importances_(self):
        """Normalized per-feature importances (xgboost sklearn semantics:
        ``gain`` for tree boosters, summing to 1; unused features 0)."""
        self._check_fitted()
        forest = self._model
        names = forest.feature_names
        score = forest.get_score(importance_type="gain")
        n = forest.num_feature or len(names or ()) or len(score)
        out = np.zeros(n, np.float32)
        for key, val in score.items():
            if names and key in names:
                idx = names.index(key)
            else:
                idx = int(key[1:]) if key.startswith("f") else int(key)
            if idx >= out.size:
                out = np.pad(out, (0, idx + 1 - out.size))
            out[idx] = val
        total = out.sum()
        return out / total if total > 0 else out


class TorchXGBRegressor(_BaseEstimator):
    """The JAX package's ``TPUXGBRegressor``; ``score`` is R^2."""

    _objective = "reg:squarederror"
    _estimator_type = "regressor"

    def predict(self, X):
        return self._predict(X)

    def score(self, X, y):
        y = np.asarray(y, np.float64).reshape(-1)
        residual = ((y - self.predict(X).astype(np.float64).reshape(-1)) ** 2).sum()
        total = ((y - y.mean()) ** 2).sum()
        if total == 0:  # sklearn's r2_score with force_finite
            return 1.0 if residual == 0 else 0.0
        return float(1.0 - residual / total)


class TorchXGBClassifier(_BaseEstimator):
    """The JAX package's ``TPUXGBClassifier``: binary:logistic, or
    multi:softprob when ``y`` holds more than two classes; ``score`` is
    accuracy."""

    _objective = "binary:logistic"
    _estimator_type = "classifier"

    def fit(self, X, y, **kwargs):
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) > 2 and not str(self.objective).startswith("multi:"):
            self.objective = "multi:softprob"
            self.params.setdefault("num_class", len(self.classes_))
        return super().fit(X, y, **kwargs)

    def predict_proba(self, X):
        out = self._predict(X)
        if out.ndim == 1:  # binary: P(class 1)
            return np.stack([1 - out, out], axis=1)
        return out

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]

    def score(self, X, y):
        return float((self.predict(X) == np.asarray(y)).mean())


class TorchXGBRanker(_BaseEstimator):
    """The JAX package's ``TPUXGBRanker`` (rank:ndcg over query groups)."""

    _objective = "rank:ndcg"

    def fit(self, X, y, group=None, sample_weight=None, verbose=False):
        dtrain = DataMatrix(np.asarray(X, np.float32), labels=np.asarray(y, np.float32),
                            weights=sample_weight,
                            groups=None if group is None else np.asarray(group, np.int32))
        return self._fit(dtrain)

    def predict(self, X):
        return self._predict(X)
