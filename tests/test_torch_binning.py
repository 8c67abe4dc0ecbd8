"""Port parity: binning, objectives and device metrics of the PyTorch port
against the JAX package, on the same seeded numpy inputs."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sagemaker_xgboost_container_tpu.data import binning as jax_binning
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import device_metrics as jax_metrics
from sagemaker_xgboost_container_tpu.models import objectives as jax_objectives
from sagemaker_xgboost_container_tpu_torch.data import binning
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import device_metrics, objectives
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc


def _features(n=3000, d=9, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[:, 1] = np.round(X[:, 1] * 3)            # few distinct values
    X[:, 2] = 7.0                              # a single value
    X[:, 3] = np.nan                           # all missing
    X[rng.rand(n, d) < 0.1] = np.nan
    X[:, 4] = rng.exponential(size=n).astype(np.float32)
    w = rng.rand(n).astype(np.float32) + 0.5
    return X, w


@pytest.mark.parametrize("max_bin", [8, 32, 256])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuts_and_bins_match_exactly(max_bin, weighted):
    X, w = _features()
    weights = w if weighted else None
    ref_cuts = jax_binning.compute_cut_points(X, weights, max_bin)
    cuts = binning.compute_cut_points(X, weights, max_bin)
    assert len(cuts) == len(ref_cuts)
    for a, b in zip(cuts, ref_cuts):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ref = jax_binning.bin_matrix(JaxDataMatrix(X, weights=weights), max_bin)
    got = binning.bin_matrix(DataMatrix(X, weights=weights), max_bin)
    assert got.bins.dtype == ref.bins.dtype
    assert np.array_equal(got.bins, ref.bins)
    # max_bin=256 needs 257 slots: uint16, not uint8
    assert got.bins.dtype == (np.uint16 if max_bin == 256 else np.uint8)


def test_bins_with_given_cuts_match():
    X, _ = _features(seed=1)
    cuts = binning.compute_cut_points(X, None, 32)
    Xv, _ = _features(n=500, seed=2)
    Xv[0, 0] = np.inf
    Xv[1, 0] = -np.inf
    assert np.array_equal(
        binning.apply_cut_points(Xv, cuts, 32),
        jax_binning.apply_cut_points(Xv, cuts, 32),
    )


def test_max_bin_below_two_raises():
    X, _ = _features(n=10)
    with pytest.raises(exc.UserError):
        binning.compute_cut_points(X, None, 1)


def _margins_labels(n=2000, seed=3):
    rng = np.random.RandomState(seed)
    margin = (rng.randn(n) * 3).astype(np.float32)
    label = (rng.rand(n) > 0.4).astype(np.float32)
    weight = (rng.rand(n) + 0.5).astype(np.float32)
    return margin, label, weight


@pytest.mark.parametrize(
    "name,params",
    [
        ("binary:logistic", {}),
        ("binary:logistic", {"scale_pos_weight": 3.0}),
        ("reg:logistic", {}),
        ("reg:squarederror", {}),
    ],
)
def test_grad_hess_match(name, params):
    m, y, w = _margins_labels()
    g, h = objectives.create_objective(name, params).grad_hess(
        torch.as_tensor(m), torch.as_tensor(y), torch.as_tensor(w)
    )
    rg, rh = jax_objectives.create_objective(name, params).grad_hess(
        jnp.asarray(m), jnp.asarray(y), jnp.asarray(w)
    )
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=1e-6)


def test_objective_transforms_match():
    ours = objectives.create_objective("binary:logistic")
    ref = jax_objectives.create_objective("binary:logistic")
    m, _, _ = _margins_labels(n=50)
    assert ours.base_margin(0.3) == ref.base_margin(0.3)
    np.testing.assert_allclose(ours.margin_to_prediction(m), ref.margin_to_prediction(m))
    assert objectives.default_base_score("binary:logistic") == 0.5
    with pytest.raises(exc.UserError):
        ours.base_margin(1.5)
    with pytest.raises(exc.UserError):
        ours.validate_labels(np.asarray([0.0, 2.0], np.float32))
    with pytest.raises(exc.UserError, match="reg:nope"):
        objectives.create_objective("reg:nope")
    with pytest.raises(exc.UserError, match="num_class"):
        objectives.create_objective("multi:softmax")


@pytest.mark.parametrize(
    "metric,objective",
    [
        ("logloss", "binary:logistic"),
        ("error", "binary:logistic"),
        ("error@0.7", "binary:logistic"),
        ("rmse", "reg:squarederror"),
    ],
)
def test_device_metrics_match(metric, objective):
    m, y, w = _margins_labels(seed=4)
    ours = device_metrics.make_device_metric(metric, objective)
    ref = jax_metrics.make_device_metric(metric, objective)
    got = float(ours(torch.as_tensor(m), torch.as_tensor(y), torch.as_tensor(w)))
    want = float(ref(jnp.asarray(m), jnp.asarray(y), jnp.asarray(w)))
    assert abs(got - want) <= 1e-6
    # a metric without a device form: the booster evaluates it on the host
    assert device_metrics.make_device_metric("mphe", objective) is None
