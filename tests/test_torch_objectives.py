"""Port parity for the objectives without query groups.

``grad_hess`` of every objective the port trains beyond the main path is
held against the JAX package's on the same margins, labels and weights
(numpy inputs from a seed), and each of those objectives trains three
rounds in both packages on the CPU: the trees must be equal in structure
and the default metric must agree within 1e-5.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models import objectives as jax_objectives
from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import objectives
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc

N = 2000


def _inputs(name, seed=0):
    """(margin, label, weight) numpy f32 suited to the objective."""
    rng = np.random.RandomState(seed)
    weight = (rng.rand(N) + 0.5).astype(np.float32)
    margin = rng.randn(N).astype(np.float32)
    if name.startswith("multi:"):
        return rng.randn(N, 3).astype(np.float32) * 2, rng.randint(0, 3, N).astype(
            np.float32), weight
    if name in ("binary:logitraw", "binary:hinge"):
        return margin, (rng.rand(N) < 0.4).astype(np.float32), weight
    if name == "count:poisson":
        return margin, rng.poisson(2.0, N).astype(np.float32), weight
    if name == "survival:cox":
        # event times with many ties in |label|, a quarter censored (< 0)
        t = rng.randint(1, 40, N).astype(np.float32)
        return margin, np.where(rng.rand(N) < 0.25, -t, t), weight
    label = (rng.rand(N) * 3 + 0.1).astype(np.float32)  # positive, for every regression
    if name == "reg:squaredlogerror":
        # predictions of log1p: near -1 the formula itself diverges (1 / (p + 1)^2)
        margin = (rng.rand(N) * 3).astype(np.float32)
    return margin, label, weight


GRAD_CASES = [
    ("reg:squaredlogerror", {}),
    ("reg:pseudohubererror", {}),
    ("reg:pseudohubererror", {"huber_slope": "2.5"}),
    ("reg:absoluteerror", {}),
    ("binary:logitraw", {"scale_pos_weight": "2"}),
    ("binary:hinge", {}),
    ("count:poisson", {}),
    ("reg:gamma", {}),
    ("reg:tweedie", {}),
    ("reg:tweedie", {"tweedie_variance_power": "1.3"}),
    ("multi:softmax", {"num_class": 3}),
    ("multi:softprob", {"num_class": 3}),
    ("survival:aft", {}),
    ("survival:aft", {"aft_loss_distribution": "logistic",
                      "aft_loss_distribution_scale": "0.7"}),
    ("survival:aft", {"aft_loss_distribution": "extreme",
                      "aft_loss_distribution_scale": "1.3"}),
    ("survival:cox", {}),
]


@pytest.mark.parametrize("name,params", GRAD_CASES,
                         ids=["{}{}".format(n, sorted(p.values())) for n, p in GRAD_CASES])
def test_grad_hess_matches_jax(name, params):
    margin, label, weight = _inputs(name)
    g, h = objectives.create_objective(name, dict(params)).grad_hess(
        torch.as_tensor(margin), torch.as_tensor(label), torch.as_tensor(weight))
    rg, rh = jax_objectives.create_objective(name, dict(params)).grad_hess(
        jnp.asarray(margin), jnp.asarray(label), jnp.asarray(weight))
    for ours, ref in ((g.numpy(), np.asarray(rg)), (h.numpy(), np.asarray(rh))):
        assert ours.shape == ref.shape and ours.dtype == np.float32
        # 1e-6 relative; f32 exp and log may differ by an ulp between XLA and
        # torch, which is large beside a gradient that cancels to near zero
        # (p - y), so the floor is 1e-6 of the largest value
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_cox_takes_its_order_once_per_label_tensor():
    margin, label, weight = _inputs("survival:cox")
    obj = objectives.create_objective("survival:cox")
    y = torch.as_tensor(label)
    obj.grad_hess(torch.as_tensor(margin), y, torch.as_tensor(weight))
    first = obj._order
    obj.grad_hess(torch.as_tensor(margin * 0.5), y, torch.as_tensor(weight))
    assert obj._order is first
    # ties in |label| keep row order (a stable sort, as jnp.argsort)
    order = first[1].numpy()
    np.testing.assert_array_equal(order, np.argsort(-np.abs(label), kind="stable"))


def test_trainable_is_every_objective_but_ranking():
    """Every objective trains; the ranking ones' gradients need the query
    groups, so their own grad_hess raises (the booster routes them through
    ops.ranking), as in the JAX package."""
    ranking = {"rank:pairwise", "rank:ndcg", "rank:map"}
    assert set(objectives.TRAINABLE) == set(objectives._REGISTRY)
    for name in ranking:
        with pytest.raises(exc.AlgorithmError, match="group"):
            objectives.create_objective(name).grad_hess(
                torch.zeros(2), torch.zeros(2), torch.ones(2))


# --- the objective sweep -----------------------------------------------------
#
# tests/test_objective_sweep.py's objectives and parameters, on a fixture of
# 2000 rows whose best split gains are well separated: on a few hundred rows
# two splits can cut a node identically, and the packages' f32 sums (in
# another order) may then keep either.

_rng = np.random.RandomState(0)
X = _rng.rand(N, 6).astype(np.float32)
SIGNAL = np.clip(X[:, 0] * 2 + X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
                 + 0.2 * _rng.randn(N), 0.05, None).astype(np.float32)
COX = np.where(_rng.rand(N) < 0.2, -SIGNAL, SIGNAL)

SWEEP = [
    ("reg:squaredlogerror", SIGNAL + 0.5, {}),
    ("reg:pseudohubererror", SIGNAL, {}),
    ("reg:absoluteerror", SIGNAL, {}),
    ("reg:gamma", SIGNAL + 0.5, {}),
    ("reg:tweedie", SIGNAL + 0.5, {"tweedie_variance_power": "1.3"}),
    ("binary:logitraw", (SIGNAL > 1.2).astype(np.float32), {"eval_metric": "error"}),
    ("binary:hinge", (SIGNAL > 1.2).astype(np.float32), {}),
    ("count:poisson", np.round(SIGNAL + 1), {}),
    ("multi:softmax", np.clip(np.round(SIGNAL), 0, 2), {"num_class": 3}),
    ("multi:softprob", np.clip(np.round(SIGNAL), 0, 2), {"num_class": 3}),
    ("survival:aft", SIGNAL + 0.5, {"base_score": "1.0"}),
    ("survival:aft", SIGNAL + 0.5, {"base_score": "1.0", "eval_metric": "rmse"}),
    ("survival:cox", COX, {}),
]


class _Log:
    def after_iteration(self, model, epoch, evals_log):
        self.log = evals_log
        return False


@pytest.mark.parametrize("objective,labels,extra", SWEEP,
                         ids=["{}-{}".format(s[0], s[2].get("eval_metric", "default"))
                              for s in SWEEP])
def test_objective_sweep_matches_jax(objective, labels, extra):
    params = {"objective": objective, "max_depth": 3, "eta": 0.3, "max_bin": 64}
    params.update(extra)
    labels = np.asarray(labels, np.float32)
    ours_log, ref_log = _Log(), _Log()
    ours = train(params, DataMatrix(X, labels), 3, evals=[(DataMatrix(X, labels), "train")],
                 device="cpu", callbacks=[ours_log], verbose_eval=False)
    ref = jax_booster.train(params, JaxDataMatrix(X, labels), 3,
                            evals=[(JaxDataMatrix(X, labels), "train")],
                            callbacks=[ref_log], verbose_eval=False)
    assert ours.tree_info == ref.tree_info
    assert len(ours.trees) == len(ref.trees) == 3 * max(1, ref.num_class)
    for a, b in zip(ours.trees, ref.trees):
        for key in ("feature", "threshold", "default_left", "left", "right"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
        np.testing.assert_allclose(a.value, b.value, rtol=1e-5, atol=1e-6)
    metric = params.get("eval_metric") or objectives.create_objective(
        objective, params).default_metric
    assert list(ours_log.log["train"]) == list(ref_log.log["train"]) == [metric]
    np.testing.assert_allclose(ours_log.log["train"][metric], ref_log.log["train"][metric],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.predict(X[:300]), ref.predict(X[:300]),
                               rtol=1e-5, atol=1e-5)
