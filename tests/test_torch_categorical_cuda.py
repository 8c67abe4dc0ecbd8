"""Categorical splits on the card: a seeded random categorical forest
predicts on CUDA within 1e-5 of the CPU (margins) and with the same
pred_leaf, on rows holding invalid categories. The generators here also
feed the CPU parity tests of ``test_torch_model_formats.py``; this module
imports no JAX, so that it collects on the GPU machine."""

import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu_torch.models.forest import Forest, Tree

# values a categorical feature must route safely: negative, fractional
# negative, out of every bitmask, >= 2^31, infinities, NaN, fractional and
# the edges of the first and second 32-bit words
SPECIAL = np.asarray([-1.0, -0.5, 1e10, 3e9, np.inf, -np.inf, np.nan, 2.7, 31.0, 32.0,
                      63.99, 0.0], np.float32)


def random_cat_trees(seed, n_trees=6, max_depth=4, d=5, n_cats=70, groups=1):
    """Tree arguments (either package's ``Tree``) of full trees of random
    depth; about 60 % of the splits on features 0-1 are categorical with
    random right-sets over 0..n_cats-1 (some empty, some holding bit 31 of
    a word)."""
    rng = np.random.RandomState(seed)
    trees = []
    for _ in range(n_trees * groups):
        depth = rng.randint(1, max_depth + 1)
        n = 2 ** (depth + 1) - 1
        ids = np.arange(n)
        internal = ids < 2 ** depth - 1
        feature = np.where(internal, rng.randint(0, d, n), 0)
        categories = {}
        for node in ids[internal]:
            if feature[node] < 2 and rng.rand() < 0.6:
                cats = np.unique(rng.randint(0, n_cats, rng.randint(0, 12)))
                if rng.rand() < 0.3:
                    cats = np.union1d(cats, [31])
                categories[int(node)] = cats
        trees.append(dict(
            feature=feature, threshold=np.where(internal, rng.randn(n), 0.0).astype(np.float32),
            default_left=rng.rand(n) < 0.5, left=np.where(internal, 2 * ids + 1, -1),
            right=np.where(internal, 2 * ids + 2, -1),
            value=np.where(internal, 0.0, rng.randn(n)).astype(np.float32),
            base_weight=rng.randn(n), gain=np.where(internal, rng.rand(n) * 10, 0.0),
            sum_hess=rng.rand(n) * 100 + 1, categories=categories))
    assert any(t["categories"] for t in trees)
    return trees


def cat_rows(seed, n, d=5, n_cats=70):
    """Rows whose features 0-1 are categories of [-2, n_cats + 8) with 15 %
    of all cells drawn from SPECIAL."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[:, :2] = rng.randint(-2, n_cats + 8, size=(n, 2))
    special = rng.rand(n, d) < 0.15
    X[special] = rng.choice(SPECIAL, int(special.sum()))
    return X


@pytest.mark.cuda
def test_categorical_predict_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    groups = 3
    forests = {}
    for device in ("cuda", "cpu"):
        forest = Forest(objective_name="multi:softprob", base_score=0.5, num_feature=5,
                        num_class=groups, device=device)
        trees = [Tree(**t) for t in random_cat_trees(12, n_trees=20, groups=groups)]
        forest.append_round(trees, [i % groups for i in range(len(trees))])
        forests[device] = forest
    X = cat_rows(13, 5000)
    np.testing.assert_allclose(forests["cuda"].predict(X, output_margin=True),
                               forests["cpu"].predict(X, output_margin=True), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(forests["cuda"].predict(X, pred_leaf=True),
                                  forests["cpu"].predict(X, pred_leaf=True))
    host, _dev = forests["cpu"]._stack()
    from sagemaker_xgboost_container_tpu_torch.ops.predict import host_leaf_nodes

    np.testing.assert_array_equal(host_leaf_nodes(host, X[:32]),
                                  forests["cuda"].predict_leaf(X[:32]))
