"""Port parity for row and column sampling and bagged rounds on the CPU:
``find_best_splits(feature_mask=)``, the builders' column masks, and
``train()`` with ``subsample`` / ``colsample_*`` / ``num_parallel_tree``
against the JAX package.

Threefry bits cannot be reproduced in torch, so the masks come from
``jax.random`` as the JAX package draws them (``JaxReplaySampler`` follows
its booster's key schedule: ``split(rng, 3)`` a round, ``fold_in(sub, k)``
for parallel tree k's rows and column stream, ``permutation(colrng, d)`` for
the tree's column set) and the port must then grow the same trees: feature,
bin, is_leaf and children identical, default_left too wherever a kept row
with a missing value reaches (elsewhere it is an f32 rounding tie), leaf
values and predictions within 1e-5. The port's own sampler is checked for
its properties: seeds, exact column counts, the kept share and resumption.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest
from sagemaker_xgboost_container_tpu.ops import lossguide as jax_lossguide
from sagemaker_xgboost_container_tpu.ops import split as jax_split
from sagemaker_xgboost_container_tpu.ops import tree_build as jax_tb
from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models.booster import TrainConfig
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.models.sampling import Sampler, TreeDraw, mask_layout
from sagemaker_xgboost_container_tpu_torch.ops import lossguide, split, tree_build
from sagemaker_xgboost_container_tpu_torch.ops.split import ColumnMasks

EXACT_KEYS = ("feature", "bin", "default_left", "is_leaf", "left", "right")
VALUE_KEYS = ("leaf_value", "base_weight", "sum_hess")
SAMPLED = {"subsample": 0.7, "colsample_bytree": 0.6, "colsample_bylevel": 0.8,
           "colsample_bynode": 0.8, "num_parallel_tree": 3}


def jax_level_masks(key, rows, d, rate):
    """[rows, d]: row i is ``uniform(fold_in(key, i), (d,)) < rate``, the
    JAX builders' bylevel draw of depth i."""
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (d,)) < rate)
                     for i in range(rows)]).astype(np.float32)


def jax_depthwise_node_masks(key, max_depth, d, rate):
    """[2**max_depth - 1, d]: level l's (2**l, d) draw from
    ``fold_in(key, 7919 + l)`` in node slots 2**l - 1 ..., as JAX
    ``build_tree`` draws colsample_bynode."""
    return np.concatenate([
        np.asarray(jax.random.uniform(jax.random.fold_in(key, 7919 + lv), (2 ** lv, d)) < rate)
        for lv in range(max_depth)]).astype(np.float32)


def jax_lossguide_node_masks(key, max_leaves, d, rate):
    """[2 * max_leaves - 1, d]: split step t's (2, d) draw from
    ``fold_in(key, 7919 + t)`` in slots 2t+1 and 2t+2; the root draws none."""
    out = np.ones((2 * max_leaves - 1, d), np.float32)
    for t in range(max_leaves - 1):
        out[2 * t + 1:2 * t + 3] = np.asarray(
            jax.random.uniform(jax.random.fold_in(key, 7919 + t), (2, d)) < rate)
    return out


def jax_tree_masks(key, config, d):
    """The ColumnMasks (leading axis 1, no tree mask) that JAX's builder
    draws from ``key`` under ``config``'s colsample_bylevel / bynode."""
    levels, _slots = mask_layout(config)
    level = node = None
    if config.colsample_bylevel < 1.0:
        level = jax_level_masks(key, levels, d, config.colsample_bylevel)
    if config.colsample_bynode < 1.0:
        if config.grow_policy == "lossguide":
            node = jax_lossguide_node_masks(key, config.max_leaves, d, config.colsample_bynode)
        else:
            node = jax_depthwise_node_masks(key, config.max_depth, d, config.colsample_bynode)
    return (None if level is None else torch.as_tensor(level)[None],
            None if node is None else torch.as_tensor(node)[None])


class JaxReplaySampler:
    """The JAX booster's draws, round by round, for ``train(_sampler=)``."""

    def __init__(self, params, n, d):
        self.config = TrainConfig(params)
        self.n, self.d = n, d
        self.rng = jax.random.PRNGKey(self.config.seed)
        self.keeps = []  # each round's row keep masks, one a parallel tree

    def draw(self, rnd):
        cfg, n, d = self.config, self.n, self.d
        self.rng, sub, colrng = jax.random.split(self.rng, 3)
        tree = None
        if cfg.colsample_bytree < 1.0:
            k = max(1, int(round(cfg.colsample_bytree * d)))
            tree = np.zeros((1, d), np.float32)
            tree[0, np.asarray(jax.random.permutation(colrng, d)[:k])] = 1.0
            tree = torch.as_tensor(tree)
        draws = []
        for k in range(cfg.num_parallel_tree):
            rng_k = jax.random.fold_in(sub, k)
            keep = None
            if cfg.subsample < 1.0:
                keep = torch.as_tensor(
                    np.asarray(jax.random.uniform(rng_k, (n,)) < cfg.subsample, np.float32))
            level, node = jax_tree_masks(rng_k, cfg, d)
            masks = None if tree is None and level is None and node is None else ColumnMasks(
                tree, level, node)
            draws.append(TreeDraw(keep, masks))
        self.keeps.append([dr.keep for dr in draws])
        return draws


def _missing_reaches(tree, X):
    """Per node: does a row of X with a missing value in the node's split
    feature reach it? Elsewhere both placements of the empty missing bucket
    score alike, and f32 rounding of the sibling-subtracted histograms picks
    ``default_left``, in each package its own way."""
    out = np.zeros(tree.num_nodes, bool)
    stack = [(0, np.ones(len(X), bool))]
    while stack:
        node, rows = stack.pop()
        if tree.left[node] < 0:
            continue
        v = X[:, tree.feature[node]]
        out[node] = bool(np.isnan(v[rows]).any())
        right = np.where(np.isnan(v), ~tree.default_left[node], v >= tree.threshold[node])
        stack += [(tree.left[node], rows & ~right), (tree.right[node], rows & right)]
    return out


def _assert_same_tree(tree, ref, out, ref_out):
    for key in EXACT_KEYS:
        assert np.array_equal(tree[key].numpy(), np.asarray(ref[key])), key
    for key in VALUE_KEYS:
        np.testing.assert_allclose(tree[key].numpy(), np.asarray(ref[key]), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)


# ---------------------------------------------------------------- split scan


@pytest.mark.parametrize("kind", ["d", "W_d"])
def test_find_best_splits_feature_mask_matches_jax(kind):
    rng = np.random.RandomState(4)
    W, d, B = 6, 8, 17
    G = (rng.randn(W, d, B) * 3).astype(np.float32)
    H = (rng.rand(W, d, B) * 5 + 0.5).astype(np.float32)
    num_cuts = np.full(d, B - 2, np.int32)
    shape = (d,) if kind == "d" else (W, d)
    mask = (rng.rand(*shape) < 0.5).astype(np.float32)
    mask.reshape(-1, d)[:, 0] = 1.0  # every node keeps a feature
    got = split.find_best_splits(*(torch.as_tensor(a) for a in (G, H, num_cuts)),
                                 feature_mask=torch.as_tensor(mask))
    ref = jax_split.find_best_splits(jnp.asarray(G), jnp.asarray(H), jnp.asarray(num_cuts),
                                     feature_mask=jnp.asarray(mask))
    for key in ("feature", "bin", "default_left"):
        assert np.array_equal(got[key].numpy(), np.asarray(ref[key])), key
    np.testing.assert_allclose(got["gain"].numpy(), np.asarray(ref["gain"]), rtol=1e-5)
    # the picked features are all unmasked, and the mask changed some pick
    picked = mask.reshape(-1, d)[np.arange(W) % mask.reshape(-1, d).shape[0],
                                 got["feature"].numpy()]
    assert (picked == 1).all()
    plain = split.find_best_splits(*(torch.as_tensor(a) for a in (G, H, num_cuts)))
    assert not torch.equal(plain["feature"], got["feature"])


def test_find_best_splits_class_axis_masks():
    """[C, 1, d] and [C, W/C, d] masks over C*W nodes equal their flat [W, d]
    forms."""
    rng = np.random.RandomState(5)
    C, Wc, d, B = 3, 2, 7, 9
    G = torch.as_tensor((rng.randn(C * Wc, d, B) * 3).astype(np.float32))
    H = torch.as_tensor((rng.rand(C * Wc, d, B) * 5 + 0.5).astype(np.float32))
    cuts = torch.full((d,), B - 2, dtype=torch.int32)
    per_class = torch.as_tensor((rng.rand(C, 1, d) < 0.5).astype(np.float32))
    per_node = torch.as_tensor((rng.rand(C, Wc, d) < 0.5).astype(np.float32))
    for mask, flat in ((per_class, per_class.expand(C, Wc, d).reshape(C * Wc, d)),
                       (per_node, per_node.reshape(C * Wc, d))):
        a = split.find_best_splits(G, H, cuts, feature_mask=mask)
        b = split.find_best_splits(G, H, cuts, feature_mask=flat)
        for key in a:
            assert torch.equal(a[key], b[key]), key


# ---------------------------------------------------------------- builders


@pytest.fixture(scope="module")
def problem():
    """Binned features with a strong signal on several features, and
    logistic gradients at margin 0 for three targets (classes)."""
    rng = np.random.RandomState(11)
    n, d, B = 3000, 9, 33
    X = rng.randn(n, d)
    bins = np.clip(((X + 3) / 6 * (B - 1)).astype(np.int64), 0, B - 2).astype(np.uint8)
    bins[rng.rand(n, d) < 0.05] = B - 1  # missing
    logits = (2.0 * X[:, 0] - 1.5 * (X[:, 1] > 0.3) + 0.8 * X[:, 2] * X[:, 3] + X[:, 6],
              -1.7 * X[:, 4] + 1.2 * (X[:, 5] > -0.4) + 0.6 * X[:, 0] - X[:, 8],
              2.2 * X[:, 6] * (X[:, 7] > 0) - 0.9 * X[:, 8] + X[:, 1])
    ys = [(z + 0.3 * rng.randn(n) > 0).astype(np.float32) for z in logits]
    grad = np.stack([0.5 - y for y in ys]).astype(np.float32)
    hess = np.full((3, n), 0.25, np.float32)
    num_cuts = np.full(d, B - 2, np.int32)
    return bins, grad, hess, num_cuts, B


@pytest.mark.parametrize("classes", [1, 3])
@pytest.mark.parametrize("policy", ["depthwise", "lossguide"])
def test_builder_masks_match_jax(problem, policy, classes):
    """The port's builder given the masks that a jax.random key draws
    against the JAX builder given the key (per class for C=3, sharing the
    key as the JAX booster's vmap over classes does)."""
    bins, grad, hess, num_cuts, B = problem
    d = bins.shape[1]
    key = jax.random.PRNGKey(7)
    params = {"grow_policy": policy, "max_depth": 4 if policy == "depthwise" else 0,
              "max_leaves": 12, "colsample_bylevel": 0.7, "colsample_bynode": 0.7}
    config = TrainConfig(params)
    tree_mask = np.zeros(d, np.float32)
    tree_mask[[0, 1, 2, 4, 5, 6, 8]] = 1.0
    level, node = jax_tree_masks(key, config, d)
    masks = ColumnMasks(torch.as_tensor(tree_mask)[None], level, node)
    kw = dict(num_bins=B, eta=0.3, min_child_weight=5.0)
    g, h = (grad[0], hess[0]) if classes == 1 else (grad, hess)
    args = [torch.as_tensor(a) for a in (bins, g, h, num_cuts)]
    jax_kw = dict(kw, feature_mask=jnp.asarray(tree_mask), rng=key,
                  colsample_bylevel=0.7, colsample_bynode=0.7)
    if policy == "depthwise":
        tree, out = tree_build.build_tree(*args, max_depth=4, masks=masks, **kw)
        plain, _ = tree_build.build_tree(*args, max_depth=4, **kw)

        def ref_tree(c):
            return jax_tb.build_tree(*(jnp.asarray(a) for a in (bins, grad[c], hess[c],
                                                               num_cuts)),
                                     max_depth=4, **jax_kw)
    else:
        tree, out = lossguide.build_tree_lossguide(*args, max_leaves=12, masks=masks, **kw)
        plain, _ = lossguide.build_tree_lossguide(*args, max_leaves=12, **kw)

        def ref_tree(c):
            return jax_lossguide.build_tree_lossguide(
                *(jnp.asarray(a) for a in (bins, grad[c], hess[c], num_cuts)),
                max_leaves=12, **jax_kw)
    for c in range(classes):
        ref, ref_out = ref_tree(c)
        mine = tree if classes == 1 else {k: v[c] for k, v in tree.items()}
        _assert_same_tree(mine, ref, out if classes == 1 else out[c], ref_out)
    # the masks changed the tree, and no split uses a feature off the tree mask
    assert not torch.equal(plain["feature"], tree["feature"])
    used = tree["feature"][~tree["is_leaf"]].numpy()
    assert (tree_mask[used] == 1).all()


# ---------------------------------------------------------------- train()


def _data(n, d=9, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    score = (2.0 * X[:, 0] - 1.5 * (X[:, 1] > 0.3) + 0.8 * X[:, 2] * X[:, 3] + X[:, 5]
             - 0.7 * X[:, 7])
    X[rng.rand(n, d) < 0.03] = np.nan
    return X, (score + 0.3 * rng.randn(n)).astype(np.float32)


def _labels(objective, score):
    if objective == "multi:softprob":
        return np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])).astype(np.float32)
    return (score > 0).astype(np.float32)


class _Log:
    def after_iteration(self, forest, rnd, evals_log):
        self.log = evals_log
        return False


CASES = {
    "binary": {"objective": "binary:logistic"},
    "softprob": {"objective": "multi:softprob", "num_class": 3},
    "binary-lossguide": {"objective": "binary:logistic", "grow_policy": "lossguide",
                         "max_leaves": 8, "max_depth": 0},
}


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request):
    X, score = _data(3000)
    Xv, score_v = _data(600, seed=1)
    objective = CASES[request.param]["objective"]
    y, yv = _labels(objective, score), _labels(objective, score_v)
    params = dict({"max_depth": 3, "max_bin": 32, "eta": 0.3, "min_child_weight": 3.0,
                   "seed": 3, "_rounds_per_dispatch": 1}, **SAMPLED)
    params.update(CASES[request.param])
    logs = _Log(), _Log()
    sampler = JaxReplaySampler(params, len(X), X.shape[1])
    ours = train(params, DataMatrix(X, y), 3, evals=[(DataMatrix(Xv, yv), "validation")],
                 device="cpu", callbacks=[logs[0]], verbose_eval=False, _sampler=sampler)
    ref = jax_booster.train(params, JaxDataMatrix(X, y), 3,
                            evals=[(JaxDataMatrix(Xv, yv), "validation")],
                            callbacks=[logs[1]], verbose_eval=False)
    # each tree's kept training rows (trees class-major within a round)
    P = params["num_parallel_tree"]
    kept = [X[keeps[i % P].numpy() > 0] for keeps in sampler.keeps
            for i in range(P * params.get("num_class", 1))]
    return ours, ref, logs[0].log, logs[1].log, Xv, params, kept


def test_sampled_training_matches_jax(trained):
    """subsample, the three colsample knobs and num_parallel_tree=3 with the
    JAX package's draws replayed: the same trees, committed class-major, and
    predictions and metrics within 1e-5."""
    ours, ref, log, ref_log, Xv, params, kept = trained
    groups = params.get("num_class", 1)
    assert len(ours.trees) == len(ref.trees) == 3 * 3 * groups
    assert ours.tree_info == [int(c) for c in ref.tree_info]
    assert ours.iteration_indptr == [int(i) for i in ref.iteration_indptr]
    for a, b, rows in zip(ours.trees, ref.trees, kept):
        for key in ("feature", "threshold", "left", "right"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
        decided = _missing_reaches(a, rows)
        assert np.array_equal(a.default_left[decided], b.default_left[decided])
        np.testing.assert_allclose(a.value, b.value, atol=1e-5)
    np.testing.assert_allclose(ours.predict(Xv, output_margin=True),
                               ref.predict(Xv, output_margin=True), atol=1e-5)
    for metric, values in ref_log["validation"].items():
        np.testing.assert_allclose(log["validation"][metric], values, atol=1e-5)
    # the bagged trees of a round differ: each drew its own rows and columns
    assert len({tuple(t.feature) for t in ours.trees[:3]}) > 1


def test_bagged_models_cross_load(trained, tmp_path):
    """P=3 models saved by either package load in the other and predict the
    same, whole and sliced to the first rounds."""
    ours, ref, _, _, Xv, _params, _kept = trained
    ours.save_model(str(tmp_path / "port.json"))
    ref.save_model(str(tmp_path / "jax.json"))
    in_jax = JaxForest.load_model(str(tmp_path / "port.json"))
    in_port = Forest.load_model(str(tmp_path / "jax.json"), device="cpu")
    for rng in (None, (0, 1), (0, 2)):
        np.testing.assert_allclose(in_jax.predict(Xv, iteration_range=rng),
                                   ours.predict(Xv, iteration_range=rng), atol=1e-5)
        np.testing.assert_allclose(in_port.predict(Xv, iteration_range=rng),
                                   ref.predict(Xv, iteration_range=rng), atol=1e-5)
    assert in_port.iteration_indptr == ours.iteration_indptr


# ---------------------------------------------------------------- the port's sampler


def _sampled_run(params, rounds=3, xgb_model=None, n=1500):
    X, score = _data(n)
    return train(dict({"max_depth": 3, "max_bin": 32, "objective": "binary:logistic"},
                      **params), DataMatrix(X, (score > 0).astype(np.float32)), rounds,
                 device="cpu", verbose_eval=False, xgb_model=xgb_model)


def test_a_seed_gives_one_model():
    a, b = _sampled_run(dict(SAMPLED, seed=1)), _sampled_run(dict(SAMPLED, seed=1))
    c = _sampled_run(dict(SAMPLED, seed=2))
    assert a.save_json() == b.save_json()
    assert a.save_json() != c.save_json()


def test_sampler_draws_exact_columns_and_kept_share():
    n, d = 20_000, 30
    config = TrainConfig(dict(SAMPLED, max_depth=4))
    sampler = Sampler(config, n, d, "cpu")
    k = round(0.6 * d)
    for rnd in range(3):
        draws = sampler.draw(rnd)
        assert len(draws) == 3
        tree = draws[0].masks.tree
        assert tree.shape == (1, d) and int(tree.sum()) == k
        assert all(torch.equal(dr.masks.tree, tree) for dr in draws)  # one set a round
        for keep, masks in draws:
            sigma = np.sqrt(n * 0.7 * 0.3)
            assert abs(float(keep.sum()) - 0.7 * n) <= 4 * sigma
            assert masks.level.shape == (1, 4, d) and masks.node.shape == (1, 15, d)
            for m, p in ((masks.level, 0.8), (masks.node, 0.8)):
                assert abs(float(m.sum()) - p * m.numel()) <= 4 * np.sqrt(m.numel() * p * (1 - p))
        assert not torch.equal(draws[0].keep, draws[1].keep)
    # one stream a fold: each fold its own draws
    folds = Sampler(config, n, d, "cpu", streams=5).draw(0)[0]
    assert folds.keep.shape == (5, n) and folds.masks.tree.shape == (5, d)
    assert (folds.masks.tree.sum(1) == k).all()
    assert len({tuple(r.tolist()) for r in folds.masks.tree}) > 1
    # lossguide: a row a depth up to the cap, a slot a node, the root unsampled
    lg = Sampler(TrainConfig(dict(SAMPLED, grow_policy="lossguide", max_leaves=6,
                                  max_depth=0)), n, d, "cpu").draw(0)[0].masks
    assert lg.level.shape == (1, 7, d) and lg.node.shape == (1, 11, d)
    assert (lg.node[:, 0] == 1).all()
    assert not Sampler.needed(TrainConfig({"num_parallel_tree": 3}))


def test_sampled_run_resumes_tree_for_tree(tmp_path):
    """A run stopped after 2 rounds and resumed for 2 more equals one of 4
    rounds: each round draws from (seed, round index)."""
    params = dict(SAMPLED, seed=5)
    whole = _sampled_run(params, rounds=4)
    first = _sampled_run(params, rounds=2)
    first.save_model(str(tmp_path / "ckpt.json"))
    resumed = _sampled_run(params, rounds=2, xgb_model=str(tmp_path / "ckpt.json"))
    assert resumed.num_boosted_rounds == 4
    for a, b in zip(whole.trees, resumed.trees):
        for key in ("feature", "threshold", "default_left", "left", "right"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
        np.testing.assert_array_equal(a.value, b.value)


@pytest.mark.cuda
def test_masked_split_scan_on_cuda_matches_cpu(problem):
    """The builder through the CUDA kernels with column masks against the
    plain versions on this well-separated problem."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this check on the card")
    bins, grad, hess, num_cuts, B = problem
    config = TrainConfig(dict(SAMPLED, max_depth=4))
    trees = {}
    for dev in ("cuda", "cpu"):
        keep, masks = Sampler(config, bins.shape[0], bins.shape[1], "cpu").draw(0)[0]
        masks = ColumnMasks(*(m.to(dev) for m in masks))
        args = [torch.as_tensor(a, device=dev) for a in (bins, grad, hess, num_cuts)]
        tree, out = tree_build.build_tree(args[0], args[1] * keep.to(dev),
                                          args[2] * keep.to(dev), args[3], max_depth=4,
                                          num_bins=B, masks=masks, min_child_weight=5.0)
        trees[dev] = ({k: v.cpu() for k, v in tree.items()}, out.cpu())
    (tree, out), (ref, ref_out) = trees["cuda"], trees["cpu"]
    for c in range(3):
        _assert_same_tree({k: v[c] for k, v in tree.items()},
                          {k: v[c].numpy() for k, v in ref.items()}, out[c], ref_out[c].numpy())
