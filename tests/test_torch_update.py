"""process_type=update (refresh / prune) of the port against the JAX package's,
on the CPU: the JAX package trains the base model, both packages update the
same file on the same numpy-seeded rows, and the updated trees are
identical in feature / threshold / is_leaf with leaf values, stored gains,
hessian sums and margins within 1e-5 (both sum the node statistics in
float64 on the host; the gradients are float32 device ops in each)."""

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.toolkit import exceptions as jax_exc
from sagemaker_xgboost_container_tpu_torch.convert import forest_from_reference
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import booster
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc

TOL = 1e-5
PARAMS = {"objective": "reg:squarederror", "max_depth": 4, "eta": 0.3, "max_bin": 64}


def _data(seed=0, n=1000, shift=0.0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 5).astype(np.float32)
    y = (X @ rng.rand(5).astype(np.float32) * 4 + shift).astype(np.float32)
    return X, y


def _multiclass(n=600):
    rng = np.random.RandomState(0)
    X = rng.rand(n, 4).astype(np.float32)
    y = rng.randint(0, 3, n).astype(np.float32)
    X[:, 0] += y
    return X, y


def _update(base_params, update_params, X, y, X_new, y_new, base_rounds, rounds):
    """(base, JAX updated, port updated) forests."""
    base = jax_booster.train(base_params, JaxDataMatrix(X, labels=y), num_boost_round=base_rounds)
    doc = base.save_json()
    ref = jax_booster.train(update_params, JaxDataMatrix(X_new, labels=y_new),
                            num_boost_round=rounds,
                            xgb_model=jax_booster.Forest.load_json(doc),
                            evals=[(JaxDataMatrix(X_new, labels=y_new), "train")])
    ours = booster.train(update_params, DataMatrix(X_new, labels=y_new), num_boost_round=rounds,
                         xgb_model=forest_from_reference(doc, device="cpu"),
                         evals=[(DataMatrix(X_new, labels=y_new), "train")], device="cpu",
                         verbose_eval=False)
    return base, ref, ours


def _assert_same(ref, ours, X):
    assert ref.iteration_indptr == ours.iteration_indptr
    for a, b in zip(ref.trees, ours.trees):
        np.testing.assert_array_equal(a.is_leaf, b.is_leaf)
        np.testing.assert_array_equal(a.left, b.left)
        split = ~a.is_leaf
        np.testing.assert_array_equal(a.feature[split], b.feature[split])
        np.testing.assert_array_equal(a.threshold[split], b.threshold[split])
        np.testing.assert_allclose(a.value, b.value, atol=TOL)
        np.testing.assert_allclose(a.base_weight, b.base_weight, atol=TOL)
        np.testing.assert_allclose(a.gain, b.gain, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(a.sum_hess, b.sum_hess, rtol=TOL)
    np.testing.assert_allclose(ref.predict(X, output_margin=True),
                               ours.predict(X, output_margin=True), atol=TOL)


def _splits(forest):
    return sum(int((~t.is_leaf).sum()) for t in forest.trees)


CASES = {
    # (update params, label shift of the update rows, base rounds, update rounds)
    "refresh_same_data": ({"updater": "refresh"}, 0.0, 4, 4),
    "refresh_shifted": ({"updater": "refresh"}, 5.0, 4, 4),
    "refresh_leaf_0": ({"updater": "refresh", "refresh_leaf": 0}, 5.0, 3, 3),
    "prune_large_gamma": ({"updater": "refresh,prune", "gamma": 1e18}, 0.0, 3, 3),
    "prune_gamma_1": ({"updater": "refresh,prune", "gamma": 1.0}, 2.0, 4, 4),
    "prune_zero_gamma": ({"updater": "refresh,prune", "gamma": 0.0}, 0.0, 3, 3),
    "prune_only": ({"updater": "prune", "gamma": 0.5}, 0.0, 3, 3),
    "round_cap": ({"updater": "refresh"}, 1.0, 2, 50),
    "fewer_rounds": ({"updater": "refresh"}, 1.0, 4, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_jax(case):
    extra, shift, base_rounds, rounds = CASES[case]
    X, y = _data()
    X_new, y_new = _data(seed=1, shift=shift)
    params = dict(PARAMS, process_type="update", **extra)
    base, ref, ours = _update(PARAMS, params, X, y, X_new, y_new, base_rounds, rounds)
    _assert_same(ref, ours, X_new)
    assert ours.num_boosted_rounds == base_rounds
    before = forest_from_reference(base.save_json(), device="cpu")
    if case == "prune_large_gamma":
        assert all(t.is_leaf[0] for t in ours.trees) and _splits(before) > 0
    if case == "refresh_shifted":
        assert np.mean(ours.predict(X_new)) > np.mean(before.predict(X_new)) + 2.0
    if case in ("refresh_leaf_0", "prune_only"):
        for a, b in zip(before.trees, ours.trees):  # no leaf value refreshed
            kept = b.is_leaf & a.is_leaf[: b.num_nodes]
            np.testing.assert_array_equal(a.value[kept], b.value[kept])
    if case == "fewer_rounds":  # rounds past the cap keep their trees
        for a, b in zip(before.trees[2:], ours.trees[2:]):
            np.testing.assert_array_equal(a.value, b.value)
    if case == "prune_gamma_1":
        assert 0 < _splits(before) - _splits(ours) < _splits(before)


def test_update_multiclass_matches_jax():
    X, y = _multiclass()
    params = {"objective": "multi:softprob", "num_class": 3, "max_depth": 3, "eta": 0.3,
              "max_bin": 64}
    base, ref, ours = _update(params, dict(params, process_type="update",
                                           updater="refresh,prune", gamma=0.5),
                              X, y, X, y, 3, 3)
    _assert_same(ref, ours, X)
    assert ours.predict(X[:50]).shape == (50, 3)


@pytest.mark.parametrize("params,base_rounds,match", [
    ({"process_type": "update", "updater": "refresh"}, 0, "existing model"),
    ({"process_type": "update", "updater": "grow_histmaker"}, 2, "refresh"),
    ({"process_type": "updte"}, 0, "process_type"),
    ({"booster": "gblinear", "process_type": "update", "updater": "refresh"}, 0, "gblinear"),
])
def test_update_refusals_match_jax(params, base_rounds, match):
    X, y = _data()
    full = dict(PARAMS, **params)
    ref_model = ours_model = None
    if base_rounds:
        base = jax_booster.train(PARAMS, JaxDataMatrix(X, labels=y), base_rounds)
        ref_model = base
        ours_model = forest_from_reference(base.save_json(), device="cpu")
    with pytest.raises(jax_exc.UserError, match=match) as ref_err:
        jax_booster.train(full, JaxDataMatrix(X, labels=y), 2, xgb_model=ref_model)
    with pytest.raises(exc.UserError, match=match) as err:
        booster.train(full, DataMatrix(X, labels=y), 2, xgb_model=ours_model, device="cpu")
    assert str(err.value).split(":")[0] == str(ref_err.value).split(":")[0]
