"""Port parity for the eval metrics: the device metrics against the JAX
package's device metrics, and the host metrics against its host metrics,
on the same margins, labels and weights (numpy inputs from a seed)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sagemaker_xgboost_container_tpu.models import device_metrics as jax_device_metrics
from sagemaker_xgboost_container_tpu.models import eval_metrics as jax_eval_metrics
from sagemaker_xgboost_container_tpu_torch.models import device_metrics, eval_metrics
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc

N = 3000


def _inputs(objective, seed=0):
    rng = np.random.RandomState(seed)
    weight = (rng.rand(N) + 0.5).astype(np.float32)
    if objective.startswith("multi:"):
        return (rng.randn(N, 4).astype(np.float32), rng.randint(0, 4, N).astype(np.float32),
                weight)
    margin = rng.randn(N).astype(np.float32)
    if objective == "binary:logistic":
        return margin, (rng.rand(N) < 0.4).astype(np.float32), weight
    if objective == "survival:cox":
        t = rng.randint(1, 50, N).astype(np.float32)
        return margin, np.where(rng.rand(N) < 0.3, -t, t), weight
    if objective == "count:poisson":
        return margin, rng.poisson(2.0, N).astype(np.float32), weight
    return margin, (rng.rand(N) * 3 + 0.1).astype(np.float32), weight


DEVICE_CASES = [
    ("multi:softprob", "merror"), ("multi:softprob", "mlogloss"),
    ("reg:squarederror", "rmse"), ("reg:squarederror", "mse"), ("reg:squarederror", "mae"),
    ("reg:squarederror", "mape"), ("reg:squaredlogerror", "rmsle"),
    ("binary:logistic", "logloss"), ("binary:logistic", "error"),
    ("binary:logistic", "error@0.7"), ("binary:logistic", "auc"),
    ("count:poisson", "poisson-nloglik"), ("reg:gamma", "gamma-nloglik"),
    ("reg:gamma", "gamma-deviance"), ("survival:cox", "cox-nloglik"),
    ("reg:tweedie", "tweedie-nloglik@1.3"), ("reg:tweedie", "tweedie-nloglik"),
]


@pytest.mark.parametrize("objective,name", DEVICE_CASES,
                         ids=["{}-{}".format(o, m) for o, m in DEVICE_CASES])
def test_device_metric_matches_jax(objective, name):
    margin, label, weight = _inputs(objective)
    groups = 4 if objective.startswith("multi:") else 1
    params = {"tweedie_variance_power": 1.6}
    ours = device_metrics.make_device_metric(name, objective, groups, params)
    ref = jax_device_metrics.make_device_metric(name, objective, groups, params)
    assert ours is not None and ref is not None
    got = float(ours(torch.as_tensor(margin), torch.as_tensor(label), torch.as_tensor(weight)))
    want = float(ref(jnp.asarray(margin), jnp.asarray(label), jnp.asarray(weight)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)


def test_metrics_without_a_device_form_go_to_the_host():
    for name in ("mphe", "aucpr", "aft-nloglik", "interval-regression-accuracy", "ndcg",
                 "ndcg@10", "map", "map@5"):
        assert device_metrics.make_device_metric(name, "reg:squarederror") is None
        assert eval_metrics.is_native_metric(name)
    assert device_metrics.make_device_metric("auc", "multi:softmax", 3) is None
    assert not eval_metrics.is_native_metric("nosuchmetric")


HOST_CASES = ["rmse", "mse", "mae", "mape", "rmsle", "mphe", "logloss", "error",
              "error@0.3", "auc", "aucpr", "poisson-nloglik", "gamma-nloglik",
              "gamma-deviance", "tweedie-nloglik@1.2", "aft-nloglik", "cox-nloglik"]


@pytest.mark.parametrize("name", HOST_CASES)
@pytest.mark.parametrize("weighted", [False, True])
def test_host_metric_matches_jax(name, weighted):
    rng = np.random.RandomState(3)
    # probabilities with ties, binary labels where the metric needs them
    preds = np.round(rng.rand(N), 2).astype(np.float32) + 0.01
    binary = name.split("@")[0] in ("logloss", "error", "auc", "aucpr")
    labels = ((rng.rand(N) < preds) if binary else rng.rand(N) * 2 + 0.1).astype(np.float32)
    if name == "cox-nloglik":
        labels = np.where(rng.rand(N) < 0.3, -labels, labels)
    weights = (rng.rand(N) + 0.5).astype(np.float32) if weighted else None
    got = eval_metrics.evaluate(name, preds, labels, weights)
    want = jax_eval_metrics.evaluate(name, preds, labels, weights)
    assert got == pytest.approx(want, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("name", ["merror", "mlogloss"])
def test_host_multiclass_metric_matches_jax(name):
    rng = np.random.RandomState(4)
    e = np.exp(rng.randn(N, 5))
    prob = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    labels = rng.randint(0, 5, N).astype(np.float32)
    got = eval_metrics.evaluate(name, None, labels, None, prob_matrix=prob)
    want = jax_eval_metrics.evaluate(name, None, labels, None, prob_matrix=prob)
    assert got == pytest.approx(want, rel=1e-12)


def test_host_metrics_refuse_what_they_cannot_compute():
    with pytest.raises(exc.UserError, match="interval-censored"):
        eval_metrics.evaluate("interval-regression-accuracy", np.ones(3), np.ones(3))
    with pytest.raises(exc.UserError, match="Unknown eval metric"):
        eval_metrics.evaluate("nosuchmetric@5", np.ones(3), np.ones(3))
