"""Port parity for monotone and interaction constraints on the CPU: the split
scan's child-order check, the depthwise and lossguide builders' alive sets,
``train()`` and fold-parallel CV against the JAX package, and the JAX
package's own monotone tests run on the port.

Trees must be identical in feature / bin / default_left / is_leaf / child
indices, with leaf values within 1e-5, on fixtures whose best gains are
well separated.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models import cv_parallel as jax_cv
from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest
from sagemaker_xgboost_container_tpu.ops import lossguide as jax_lossguide
from sagemaker_xgboost_container_tpu.ops import split as jax_split
from sagemaker_xgboost_container_tpu.ops import tree_build as jax_tb
from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import cv_parallel
from sagemaker_xgboost_container_tpu_torch.models.booster import TrainConfig
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.ops import lossguide, split, tree_build

EXACT_KEYS = ("feature", "bin", "default_left", "is_leaf", "left", "right")
VALUE_KEYS = ("leaf_value", "base_weight", "sum_hess")
MONOTONE = np.asarray([1, -1, 0, 1, 0, 0, -1, 0, 1], np.int32)
SETS = [[0, 3], [1, 2], [4, 5, 6, 7, 8], [2, 8]]


def _sets(d, sets=SETS):
    out = np.zeros((len(sets), d), bool)
    for i, members in enumerate(sets):
        out[i, members] = True
    return out


def _random_hists(W, d, B, seed):
    rng = np.random.RandomState(seed)
    G = (rng.randn(W, d, B) * 3).astype(np.float32)
    H = (rng.rand(W, d, B) * 5 + 0.5).astype(np.float32)
    return G, H


@pytest.mark.parametrize("W,C", [(5, 1), (4, 3)])
@pytest.mark.parametrize("params", [{}, {"reg_lambda": 2.0, "alpha": 0.5, "gamma": 0.1}])
def test_find_best_splits_monotone_matches_jax(W, C, params):
    """The child-order check on [W, d, B] and on the class axis [C*W, d, B]
    (the JAX package scans the C*W nodes the same way), with a [C, W, d]
    mask on the class axis."""
    d, B = 9, 17
    G, H = _random_hists(C * W, d, B, seed=7 + C)
    num_cuts = np.full(d, B - 2, np.int32)
    mask = (np.random.RandomState(3).rand(C, W, d) < 0.8).astype(np.float32)
    mask[..., 0] = 1.0
    got = split.find_best_splits(
        torch.as_tensor(G), torch.as_tensor(H), torch.as_tensor(num_cuts),
        feature_mask=torch.as_tensor(mask if C > 1 else mask[0]),
        monotone=torch.as_tensor(MONOTONE), **params)
    ref = jax_split.find_best_splits(
        jnp.asarray(G), jnp.asarray(H), jnp.asarray(num_cuts),
        feature_mask=jnp.asarray(mask.reshape(C * W, d)), monotone=jnp.asarray(MONOTONE),
        **params)
    for key in ("feature", "bin", "default_left"):
        assert np.array_equal(got[key].numpy(), np.asarray(ref[key])), key
    np.testing.assert_allclose(got["gain"].numpy(), np.asarray(ref["gain"]), rtol=1e-5)
    # the constraint changed some node's pick, and every pick on a
    # constrained feature orders its children's weights
    free = split.find_best_splits(
        torch.as_tensor(G), torch.as_tensor(H), torch.as_tensor(num_cuts),
        feature_mask=torch.as_tensor(mask if C > 1 else mask[0]), **params)
    assert not torch.equal(free["gain"], got["gain"])
    lam, alpha = params.get("reg_lambda", 1.0), params.get("alpha", 0.0)
    for w in range(C * W):
        f, b = int(got["feature"][w]), int(got["bin"][w])
        if MONOTONE[f] == 0 or not np.isfinite(float(got["gain"][w])):
            continue
        miss = int(got["default_left"][w])
        gl = G[w, f, :b + 1].sum() + miss * G[w, f, B - 1]
        hl = H[w, f, :b + 1].sum() + miss * H[w, f, B - 1]
        gr, hr = G[w, 0].sum() - gl, H[w, 0].sum() - hl
        wl = -np.sign(gl) * max(abs(gl) - alpha, 0) / (hl + lam)
        wr = -np.sign(gr) * max(abs(gr) - alpha, 0) / (hr + lam)
        assert (wl <= wr + 1e-6) if MONOTONE[f] > 0 else (wl >= wr - 1e-6)


@pytest.fixture(scope="module")
def problem():
    """Binned features with a strong, well-separated signal, and logistic
    gradients at margin 0 for three targets (classes)."""
    rng = np.random.RandomState(11)
    n, d, B = 3000, 9, 33
    X = rng.randn(n, d)
    bins = np.clip(((X + 3) / 6 * (B - 1)).astype(np.int64), 0, B - 2).astype(np.uint8)
    bins[rng.rand(n, d) < 0.05] = B - 1  # missing
    logits = (2.0 * X[:, 0] - 1.5 * (X[:, 1] > 0.3) + 0.8 * X[:, 2] * X[:, 3],
              -1.7 * X[:, 4] + 1.2 * (X[:, 5] > -0.4) + 0.6 * X[:, 0],
              2.2 * X[:, 6] * (X[:, 7] > 0) - 0.9 * X[:, 8])
    ys = [(z + 0.3 * rng.randn(n) > 0).astype(np.float32) for z in logits]
    grad = np.stack([0.5 - y for y in ys]).astype(np.float32)
    hess = np.full((3, n), 0.25, np.float32)
    num_cuts = np.full(d, B - 2, np.int32)
    return bins, grad, hess, num_cuts, B


def _assert_same_tree(tree, ref, out, ref_out):
    for key in EXACT_KEYS:
        assert np.array_equal(tree[key].numpy(), np.asarray(ref[key])), key
    for key in VALUE_KEYS:
        np.testing.assert_allclose(tree[key].numpy(), np.asarray(ref[key]), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)


def _paths(tree, is_leaf, left, right, node=0, used=()):
    """The features split on along each root-to-leaf path of a padded tree."""
    if is_leaf[node]:
        return [used]
    used = used + (int(tree[node]),)
    return (_paths(tree, is_leaf, left, right, int(left[node]), used)
            + _paths(tree, is_leaf, left, right, int(right[node]), used))


def _constraint_kw(kind, d):
    out = {}
    if kind in ("monotone", "both"):
        out["monotone"] = MONOTONE[:d]
    if kind in ("interaction", "both"):
        out["interaction_sets"] = _sets(d)
    return out


@pytest.mark.parametrize("kind", ["monotone", "interaction", "both"])
@pytest.mark.parametrize("max_depth", [3, 5])
def test_build_tree_with_constraints_matches_jax(problem, kind, max_depth):
    bins, grad, hess, num_cuts, B = problem
    extra = _constraint_kw(kind, bins.shape[1])
    kw = dict(max_depth=max_depth, num_bins=B, eta=0.3, min_child_weight=5.0)
    tree, out = tree_build.build_tree(
        *(torch.as_tensor(a) for a in (bins, grad[0], hess[0], num_cuts)), **kw,
        **{k: torch.as_tensor(v) for k, v in extra.items()})
    ref, ref_out = jax_tb.build_tree(
        jnp.asarray(bins), jnp.asarray(grad[0]), jnp.asarray(hess[0]), jnp.asarray(num_cuts),
        **kw, **{k: jnp.asarray(v) for k, v in extra.items()})
    _assert_same_tree(tree, ref, out, ref_out)
    if "interaction_sets" in extra:
        sets = _sets(bins.shape[1])
        paths = _paths(tree["feature"], tree["is_leaf"], tree["left"], tree["right"])
        assert any(len(p) > 1 for p in paths)
        for p in paths:
            assert any(sets[s, list(p)].all() for s in range(len(sets))), p


@pytest.mark.parametrize("kind", ["monotone", "interaction", "both"])
def test_build_tree_class_axis_with_constraints_matches_jax_per_class(problem, kind):
    bins, grad, hess, num_cuts, B = problem
    extra = _constraint_kw(kind, bins.shape[1])
    kw = dict(max_depth=4, num_bins=B, eta=0.3, min_child_weight=5.0)
    tree, out = tree_build.build_tree(
        *(torch.as_tensor(a) for a in (bins, grad, hess, num_cuts)), **kw,
        **{k: torch.as_tensor(v) for k, v in extra.items()})
    for c in range(3):
        ref, ref_out = jax_tb.build_tree(
            jnp.asarray(bins), jnp.asarray(grad[c]), jnp.asarray(hess[c]),
            jnp.asarray(num_cuts), **kw, **{k: jnp.asarray(v) for k, v in extra.items()})
        _assert_same_tree({k: v[c] for k, v in tree.items()}, ref, out[c], ref_out)


@pytest.mark.parametrize("kind", ["monotone", "interaction", "both"])
@pytest.mark.parametrize("max_leaves,max_depth", [(9, 0), (16, 4)])
def test_build_tree_lossguide_with_constraints_matches_jax(problem, kind, max_leaves,
                                                           max_depth):
    bins, grad, hess, num_cuts, B = problem
    extra = _constraint_kw(kind, bins.shape[1])
    kw = dict(max_leaves=max_leaves, max_depth=max_depth, num_bins=B, eta=0.3,
              min_child_weight=20.0)
    tree, out = lossguide.build_tree_lossguide(
        *(torch.as_tensor(a) for a in (bins, grad[0], hess[0], num_cuts)), **kw,
        **{k: torch.as_tensor(v) for k, v in extra.items()})
    ref, ref_out = jax_lossguide.build_tree_lossguide(
        jnp.asarray(bins), jnp.asarray(grad[0]), jnp.asarray(hess[0]), jnp.asarray(num_cuts),
        **kw, **{k: jnp.asarray(v) for k, v in extra.items()})
    _assert_same_tree(tree, ref, out, ref_out)
    if "interaction_sets" in extra:
        sets = _sets(bins.shape[1])
        for p in _paths(tree["feature"], tree["is_leaf"], tree["left"], tree["right"]):
            assert any(sets[s, list(p)].all() for s in range(len(sets))), p


def test_build_tree_lossguide_class_axis_with_constraints_matches_jax(problem):
    bins, grad, hess, num_cuts, B = problem
    extra = _constraint_kw("both", bins.shape[1])
    kw = dict(max_leaves=9, max_depth=0, num_bins=B, eta=0.3, min_child_weight=20.0)
    tree, out = lossguide.build_tree_lossguide(
        *(torch.as_tensor(a) for a in (bins, grad, hess, num_cuts)), **kw,
        **{k: torch.as_tensor(v) for k, v in extra.items()})
    for c in range(3):
        ref, ref_out = jax_lossguide.build_tree_lossguide(
            jnp.asarray(bins), jnp.asarray(grad[c]), jnp.asarray(hess[c]),
            jnp.asarray(num_cuts), **kw, **{k: jnp.asarray(v) for k, v in extra.items()})
        _assert_same_tree({k: v[c] for k, v in tree.items()}, ref, out[c], ref_out)


def _data(n=3000, d=9, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    score = 2.0 * X[:, 0] - 1.5 * (X[:, 1] > 0.3) + 0.8 * X[:, 2] * X[:, 3]
    X[rng.rand(n, d) < 0.03] = np.nan
    return X, score + 0.3 * rng.randn(n).astype(np.float32)


class _Log:
    def after_iteration(self, forest, rnd, evals_log):
        self.log = evals_log
        return False


CONSTRAINED = {
    "monotone": {"monotone_constraints": (1, -1, 0, 1)},
    "interaction": {"interaction_constraints": [[0, 3], [1, 2], [4, 5, 6, 7, 8]]},
    "lossguide+both": {"grow_policy": "lossguide", "max_leaves": 12, "max_depth": 0,
                       "monotone_constraints": (1, -1, 0, 1),
                       "interaction_constraints": [[0, 3], [1, 2, 8]]},
    "multiclass+both": {"objective": "multi:softprob", "num_class": 3,
                        "monotone_constraints": (1, -1),
                        "interaction_constraints": [[0, 3], [1, 2]]},
}


@pytest.fixture(scope="module", params=sorted(CONSTRAINED))
def trained(request):
    X, score = _data()
    Xv, score_v = _data(n=800, seed=1)
    params = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32, "eta": 0.3,
              "min_child_weight": 5.0, "tree_method": "hist"}
    params.update(CONSTRAINED[request.param])
    if params["objective"] == "multi:softprob":
        cut = lambda s: np.digitize(s, np.quantile(score, [1 / 3, 2 / 3]))  # noqa: E731
        y, yv = cut(score).astype(np.float32), cut(score_v).astype(np.float32)
    else:
        y, yv = (score > 0).astype(np.float32), (score_v > 0).astype(np.float32)
    logs = _Log(), _Log()
    ours = train(params, DataMatrix(X, y), 3, evals=[(DataMatrix(Xv, yv), "validation")],
                 device="cpu", callbacks=[logs[0]], verbose_eval=False)
    ref = jax_booster.train(params, JaxDataMatrix(X, y), 3,
                            evals=[(JaxDataMatrix(Xv, yv), "validation")],
                            callbacks=[logs[1]], verbose_eval=False)
    return request.param, ours, ref, logs[0].log, logs[1].log, Xv


def test_train_with_constraints_matches_jax(trained):
    kind, ours, ref, log, ref_log, Xv = trained
    assert len(ours.trees) == len(ref.trees) and ours.tree_info == list(ref.tree_info)
    for a, b in zip(ours.trees, ref.trees):
        for key in ("feature", "threshold", "default_left", "left", "right"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
        np.testing.assert_allclose(a.value, b.value, atol=1e-5)
    np.testing.assert_allclose(ours.predict(Xv, output_margin=True),
                               ref.predict(Xv, output_margin=True), atol=1e-5)
    for metric, values in ref_log["validation"].items():
        np.testing.assert_allclose(log["validation"][metric], values, atol=1e-5)


def test_train_with_constraints_keeps_them(trained):
    """Every root-to-leaf path draws its features from one interaction set;
    every split on a monotone feature orders its children's weights."""
    kind, ours, _, _, _, _ = trained
    params = CONSTRAINED[kind]
    mono = params.get("monotone_constraints", ())
    sets = params.get("interaction_constraints")
    checked = 0
    for t in ours.trees:
        is_leaf = t.left < 0
        if sets is not None:
            for p in _paths(t.feature, is_leaf, t.left, t.right):
                assert any(set(p) <= set(s) for s in sets), (kind, p)
        for i in range(t.num_nodes):
            f = int(t.feature[i])
            if not is_leaf[i] and f < len(mono) and mono[f] != 0:
                wl, wr = t.base_weight[t.left[i]], t.base_weight[t.right[i]]
                assert (wl <= wr) if mono[f] > 0 else (wl >= wr), (kind, i)
                checked += 1
    assert checked > 0 or not mono


def _monotone_fixture():
    """The JAX package's fixture: a non-monotone signal in one feature."""
    rng = np.random.RandomState(5)
    X = rng.rand(1500, 1).astype(np.float32)
    y = (np.sin(X[:, 0] * 6) + X[:, 0]).astype(np.float32)
    return X, y


@pytest.mark.parametrize("growth", [
    {"max_depth": 4},
    {"grow_policy": "lossguide", "max_leaves": 16, "max_depth": 0},
])
def test_monotone_constraint_enforced(growth):
    """The JAX package's tests/test_booster.py monotone tests on the port:
    one feature, so the children-order check makes the model monotone."""
    X, y = _monotone_fixture()
    params = dict(growth, monotone_constraints=(1,), tree_method="hist")
    forest = train(params, DataMatrix(X, y), 10, device="cpu", verbose_eval=False)
    grid = np.linspace(0, 1, 200, dtype=np.float32).reshape(-1, 1)
    preds = forest.predict(grid)
    assert (np.diff(preds) >= -1e-5).all()
    ref = jax_booster.train(params, JaxDataMatrix(X, labels=y), 10, verbose_eval=False)
    np.testing.assert_allclose(preds, np.asarray(ref.predict(grid)), atol=1e-5)


def test_monotone_models_cross_load(trained, tmp_path):
    _, ours, ref, _, _, Xv = trained
    ours.save_model(str(tmp_path / "port.json"))
    np.testing.assert_allclose(JaxForest.load_model(str(tmp_path / "port.json")).predict(Xv),
                               ours.predict(Xv), atol=1e-5)
    ref.save_model(str(tmp_path / "jax.json"))
    np.testing.assert_allclose(
        Forest.load_model(str(tmp_path / "jax.json"), device="cpu").predict(Xv),
        ref.predict(Xv), atol=1e-5)


def test_train_config_takes_constraints_as_given():
    cfg = TrainConfig({"monotone_constraints": (1, 0, -1),
                       "interaction_constraints": [[0, 1], [2, 3]]})
    assert cfg.monotone_constraints == (1, 0, -1)
    assert cfg.interaction_constraints == [[0, 1], [2, 3]]
    ref = jax_booster.TrainConfig({"monotone_constraints": (1, 0, -1)})
    assert ref.monotone_constraints == cfg.monotone_constraints


@pytest.mark.parametrize("constraints", [
    {"monotone_constraints": (1, 0, -1)},
    {"interaction_constraints": [[0, 3], [1, 2, 4]]},
])
def test_fold_parallel_cv_with_constraints_matches_jax(constraints, monkeypatch):
    """Every fold of a fold-parallel CV keeps the constraints, tree for tree
    as the JAX package's vmapped folds (one JAX device: the folds in one
    program)."""
    import jax

    one = jax.devices()[:1]
    monkeypatch.setattr(jax_cv.jax, "devices", lambda: one)
    X, score = _data(n=1500)
    y = (score > 0).astype(np.float32)
    rng = np.random.RandomState(2)
    perm = rng.permutation(len(y))
    folds = np.array_split(perm, 3)
    splits = [(np.sort(np.concatenate([folds[j] for j in range(3) if j != k])),
               np.sort(folds[k])) for k in range(3)]
    params = dict({"objective": "binary:logistic", "max_depth": 3, "max_bin": 32, "eta": 0.3,
                   "eval_metric": "logloss"}, **constraints)
    cfg = TrainConfig(params)
    assert cv_parallel.parallel_cv_supported(cfg, ["logloss"], False)
    jcfg = jax_booster.TrainConfig(params)
    assert jax_cv.parallel_cv_supported(jcfg, ["logloss"], False)
    forests, results = cv_parallel.train_cv_parallel(
        cfg, DataMatrix(X, y), splits, 3, ["logloss"],
        lambda: Forest(objective_name="binary:logistic", base_score=0.5,
                       num_feature=X.shape[1], device="cpu"), "cpu")
    ref_forests, ref_results = jax_cv.train_cv_parallel(
        jcfg, JaxDataMatrix(X, y), splits, 3, ["logloss"],
        lambda: JaxForest(objective_name="binary:logistic", base_score=0.5,
                          num_feature=X.shape[1]))
    for ours, ref in zip(forests, ref_forests):
        for a, b in zip(ours.trees, ref.trees):
            for key in ("feature", "threshold", "left", "right"):
                assert np.array_equal(getattr(a, key), getattr(b, key)), key
            np.testing.assert_allclose(a.value, b.value, atol=1e-5)
    for ours, ref in zip(results, ref_results):
        np.testing.assert_allclose(ours["validation"]["logloss"],
                                   ref["validation"]["logloss"], atol=1e-5)
