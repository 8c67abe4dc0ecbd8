"""Port parity: split scan, tree growth, tree packing and binned prediction
of the PyTorch port against the JAX package on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sagemaker_xgboost_container_tpu.ops import split as jax_split
from sagemaker_xgboost_container_tpu.ops import tree_build as jax_tb
from sagemaker_xgboost_container_tpu_torch.ops import split, tree_build


def _tensors(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _random_hists(W=4, d=6, B=17, seed=0):
    rng = np.random.RandomState(seed)
    G = rng.randn(W, d, B).astype(np.float32) * 3
    H = (rng.rand(W, d, B) * 5 + 0.5).astype(np.float32)
    return G, H


def _tie_hists():
    """Two features with identical histograms: every candidate of feature 3
    ties with the same candidate of feature 1."""
    G, H = _random_hists(W=3, d=5, B=9, seed=1)
    G[:, 3, :] = G[:, 1, :]
    H[:, 3, :] = H[:, 1, :]
    # make feature 1 the best: a strong split at bin 2
    G[:, 1, :3] -= 6.0
    G[:, 1, 3:-1] += 6.0 * 3 / 5
    G[:, 3, :] = G[:, 1, :]
    # node totals come from feature 0: give it feature 1's totals, all in
    # bin 0, so that it has no legal split of its own
    for A in (G, H):
        A[:, 0, :] = 0.0
        A[:, 0, 0] = A[:, 1, :].sum(-1)
    return G, H


@pytest.mark.parametrize("fixture", ["random", "tie"])
@pytest.mark.parametrize(
    "params",
    [
        {},
        {"reg_lambda": 2.0, "alpha": 0.5, "gamma": 0.1, "min_child_weight": 3.0},
    ],
)
def test_find_best_splits_matches_jax(fixture, params):
    G, H = _random_hists() if fixture == "random" else _tie_hists()
    d, B = G.shape[1], G.shape[2]
    num_cuts = np.full(d, B - 2, np.int32)
    num_cuts[-1] = 3
    got = split.find_best_splits(*_tensors(G, H, num_cuts), **params)
    ref = jax_split.find_best_splits(
        jnp.asarray(G), jnp.asarray(H), jnp.asarray(num_cuts), **params
    )
    for key in ("feature", "bin", "default_left"):
        assert np.array_equal(got[key].numpy(), np.asarray(ref[key])), key
    np.testing.assert_allclose(got["gain"].numpy(), np.asarray(ref["gain"]), rtol=1e-5)
    np.testing.assert_allclose(got["g_total"].numpy(), np.asarray(ref["g_total"]), rtol=1e-5)
    if fixture == "tie":
        # the first index of the max wins: feature 1, never its twin 3
        assert (got["feature"].numpy() == 1).all()


def test_argmax_takes_first_of_ties():
    assert int(torch.argmax(torch.tensor([0.5, 2.0, 1.0, 2.0, 2.0]))) == 1


def test_leaf_weight_matches_jax():
    rng = np.random.RandomState(2)
    g = (rng.randn(50) * 4).astype(np.float32)
    h = (rng.rand(50) * 3).astype(np.float32)
    for kw in ({}, {"alpha": 0.7, "reg_lambda": 0.5, "max_delta_step": 0.3}):
        got = split.leaf_weight(*_tensors(g, h), **kw).numpy()
        want = np.asarray(jax_split.leaf_weight(jnp.asarray(g), jnp.asarray(h), **kw))
        np.testing.assert_allclose(got, want, atol=1e-7)


@pytest.fixture
def separated_problem():
    """Binned features with a strong, well-separated signal, and logistic
    gradients at margin 0: best gains differ by far more than float noise."""
    rng = np.random.RandomState(11)
    n, d, B = 3000, 9, 33
    X = rng.randn(n, d)
    bins = np.clip(((X + 3) / 6 * (B - 1)).astype(np.int64), 0, B - 2).astype(np.uint8)
    bins[rng.rand(n, d) < 0.05] = B - 1  # missing
    logit = 2.0 * X[:, 0] - 1.5 * (X[:, 1] > 0.3) + 0.8 * X[:, 2] * X[:, 3]
    y = (logit + 0.3 * rng.randn(n) > 0).astype(np.float32)
    grad = (0.5 - y).astype(np.float32)
    hess = np.full(n, 0.25, np.float32)
    num_cuts = np.full(d, B - 2, np.int32)
    return bins, grad, hess, num_cuts, B


@pytest.mark.parametrize("max_depth", [1, 4, 5])
def test_build_tree_matches_jax(separated_problem, max_depth):
    bins, grad, hess, num_cuts, B = separated_problem
    kw = dict(max_depth=max_depth, num_bins=B, eta=0.3, reg_lambda=1.0, min_child_weight=1.0)
    tree, row_out = tree_build.build_tree(*_tensors(bins, grad, hess, num_cuts), **kw)
    ref, ref_out = jax_tb.build_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(num_cuts), **kw
    )
    for key in ("feature", "bin", "default_left", "is_leaf", "left", "right"):
        assert np.array_equal(tree[key].numpy(), np.asarray(ref[key])), key
    for key in ("leaf_value", "base_weight", "sum_hess"):
        np.testing.assert_allclose(tree[key].numpy(), np.asarray(ref[key]), atol=2e-4)
    np.testing.assert_allclose(row_out.numpy(), np.asarray(ref_out), atol=2e-4)
    assert not tree["is_leaf"][0]  # the root really split


def test_pack_unpack_round_trip(separated_problem):
    bins, grad, hess, num_cuts, B = separated_problem
    tree, _ = tree_build.build_tree(*_tensors(bins, grad, hess, num_cuts), max_depth=3, num_bins=B)
    host = tree_build.unpack_tree(tree_build.pack_tree(tree))
    again = tree_build.tree_from_packed(tree_build.pack_tree(tree))
    for key, value in tree.items():
        assert np.array_equal(host[key], value.numpy()), key
        assert torch.equal(again[key], value), key
    # same field order and dtypes as the JAX package's unpack_tree
    ref = jax_tb.unpack_tree(tree_build.pack_tree(tree).numpy())
    for key in ref:
        assert ref[key].dtype == host[key].dtype and np.array_equal(ref[key], host[key])


def test_predict_binned_matches_row_out_and_jax(separated_problem):
    bins, grad, hess, num_cuts, B = separated_problem
    tree, row_out = tree_build.build_tree(*_tensors(bins, grad, hess, num_cuts), max_depth=4, num_bins=B)
    pred = tree_build.predict_binned(tree, torch.as_tensor(bins), 4, B)
    np.testing.assert_allclose(pred.numpy(), row_out.numpy(), atol=1e-7)
    jtree = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    ref = jax_tb.predict_binned(jtree, jnp.asarray(bins), 4, B)
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref), atol=1e-7)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32])
def test_row_bin_lookup(dtype):
    rng = np.random.RandomState(3)
    bins = rng.randint(0, 257 if dtype != np.uint8 else 255, size=(40, 7)).astype(dtype)
    feat = rng.randint(0, 7, 40).astype(np.int32)
    got = tree_build.row_bin_lookup(torch.as_tensor(bins), torch.as_tensor(feat))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), bins[np.arange(40), feat].astype(np.int32))


def test_subtraction_gate_matches_jax():
    for depth, d, B in ((1, 28, 257), (8, 28, 257), (12, 2000, 257)):
        assert tree_build._subtraction_enabled(depth, d, B) == jax_tb._subtraction_enabled(depth, d, B)
