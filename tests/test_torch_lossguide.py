"""Port parity for leaf-wise growth (grow_policy=lossguide) on the CPU: the
builder, ``train()`` and the model files against the JAX package.

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
from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest
from sagemaker_xgboost_container_tpu.ops import lossguide as jax_lossguide
from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models.booster import TrainConfig
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.ops import histogram, lossguide, tree_build
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc

EXACT_KEYS = ("feature", "bin", "default_left", "is_leaf", "left", "right")
VALUE_KEYS = ("leaf_value", "base_weight", "sum_hess")


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


def _jax_tree(bins, grad, hess, num_cuts, B, **kw):
    tree, out = jax_lossguide.build_tree_lossguide(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(num_cuts),
        num_bins=B, **kw)
    return {k: np.asarray(v) for k, v in tree.items()}, np.asarray(out)


def _assert_same_tree(tree, ref, out, ref_out):
    for key in EXACT_KEYS:
        assert np.array_equal(tree[key].numpy(), ref[key]), key
    for key in VALUE_KEYS:
        np.testing.assert_allclose(tree[key].numpy(), ref[key], atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5)


@pytest.mark.parametrize("subtract", [True, False])
@pytest.mark.parametrize("max_depth", [0, 3])
@pytest.mark.parametrize("max_leaves", [2, 7, 31])
def test_build_tree_lossguide_matches_jax(problem, max_leaves, max_depth, subtract,
                                          monkeypatch):
    bins, grad, hess, num_cuts, B = problem
    if not subtract:
        monkeypatch.setattr(histogram, "SUBTRACT_MEM", -1)
        monkeypatch.setenv("GRAFT_HIST_SUBTRACT", "0")
    assert lossguide._subtraction_enabled(max_leaves, bins.shape[1], B) == subtract
    kw = dict(max_leaves=max_leaves, max_depth=max_depth, eta=0.3, reg_lambda=1.0,
              min_child_weight=30.0)
    tree, out = lossguide.build_tree_lossguide(
        *(torch.as_tensor(a) for a in (bins, grad[0], hess[0], num_cuts)), num_bins=B, **kw)
    ref, ref_out = _jax_tree(bins, grad[0], hess[0], num_cuts, B, **kw)
    _assert_same_tree(tree, ref, out, ref_out)
    splits = int((~tree["is_leaf"]).sum())
    assert splits >= 1
    if max_depth == 3 and max_leaves == 31:
        # the depth cap leaves at most 8 leaves: most steps cannot split
        assert splits <= 7
    assert tree["feature"].shape == (2 * max_leaves - 1,)


def test_steps_that_cannot_split_change_nothing(problem):
    """min_child_weight so large that only a few splits are legal: the later
    steps find no gain above MIN_SPLIT_LOSS and leave the tree as it was."""
    bins, grad, hess, num_cuts, B = problem
    kw = dict(max_leaves=31, max_depth=0, min_child_weight=250.0)
    tree, out = lossguide.build_tree_lossguide(
        *(torch.as_tensor(a) for a in (bins, grad[0], hess[0], num_cuts)), num_bins=B, **kw)
    ref, ref_out = _jax_tree(bins, grad[0], hess[0], num_cuts, B, **kw)
    _assert_same_tree(tree, ref, out, ref_out)
    splits = int((~tree["is_leaf"]).sum())
    assert 1 <= splits < 30
    # slots of the steps that could not split stay self-looped leaves
    ids = np.arange(61)
    used = 2 * splits + 1
    assert tree["is_leaf"][used:].all()
    assert np.array_equal(tree["left"][used:].numpy(), ids[used:])


@pytest.mark.parametrize("subtract", [True, False])
def test_class_axis_matches_jax_per_class(problem, subtract, monkeypatch):
    """C trees on [C, n] gradients in one loop (one histogram call a step for
    every class), each class picking its own leaf, equal the JAX builder
    run on each class (what the JAX package vmaps)."""
    bins, grad, hess, num_cuts, B = problem
    if not subtract:
        monkeypatch.setattr(histogram, "SUBTRACT_MEM", -1)
        monkeypatch.setenv("GRAFT_HIST_SUBTRACT", "0")
    calls = []
    monkeypatch.setattr(lossguide, "level_histogram",
                        lambda *a: calls.append(a[4]) or histogram.level_histogram(*a))
    kw = dict(max_leaves=9, max_depth=0, eta=0.3, min_child_weight=20.0)
    tree, out = lossguide.build_tree_lossguide(
        *(torch.as_tensor(a) for a in (bins, grad, hess, num_cuts)), num_bins=B, **kw)
    assert calls == [1] + [1 if subtract else 2] * 8  # the root, then one a step
    for c in range(3):
        ref, ref_out = _jax_tree(bins, grad[c], hess[c], num_cuts, B, **kw)
        _assert_same_tree({k: v[c] for k, v in tree.items()}, ref, out[c], ref_out)
    # the classes grew different trees
    assert len({tuple(tree["feature"][c].tolist()) for c in range(3)}) == 3


def test_argmax_takes_the_first_of_exact_ties_as_jax():
    rng = np.random.RandomState(5)
    gains = rng.choice([-np.inf, 0.5, 1.25, 3.0], size=(6, 40)).astype(np.float32)
    gains[2, :] = -np.inf
    gains[3, [4, 17, 30]] = 7.0
    got = torch.argmax(torch.as_tensor(gains), dim=1).numpy()
    want = np.asarray(jnp.argmax(jnp.asarray(gains), axis=1))
    assert np.array_equal(got, want)
    assert got[2] == 0 and got[3] == 4


def test_predict_binned_at_predict_depth_matches_row_out(problem):
    bins, grad, hess, num_cuts, B = problem
    tree, out = lossguide.build_tree_lossguide(
        *(torch.as_tensor(a) for a in (bins, grad[0], hess[0], num_cuts)), num_bins=B,
        max_leaves=15, max_depth=0)
    depth = TrainConfig({"grow_policy": "lossguide", "max_leaves": 15,
                         "max_depth": 0}).predict_depth
    assert depth == 14
    pred = tree_build.predict_binned(tree, torch.as_tensor(bins), depth, B)
    np.testing.assert_allclose(pred.numpy(), out.numpy(), atol=1e-7)


def _data(n=3000, d=9, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    score = 2.0 * X[:, 0] - 1.5 * (X[:, 1] > 0.3) + 0.8 * X[:, 2] * X[:, 3]
    X[rng.rand(n, d) < 0.03] = np.nan
    return X, score + 0.3 * rng.randn(n).astype(np.float32)


def _labels(objective, score):
    if objective == "binary:logistic":
        return (score > 0).astype(np.float32)
    if objective == "multi:softprob":
        return np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])).astype(np.float32)
    return score.astype(np.float32)


class _Log:
    def after_iteration(self, forest, rnd, evals_log):
        self.log = evals_log
        return False


@pytest.fixture(scope="module",
                params=["binary:logistic", "reg:squarederror", "multi:softprob"])
def trained(request):
    X, score = _data()
    Xv, score_v = _data(n=800, seed=1)
    y, yv = _labels(request.param, score), _labels(request.param, score_v)
    params = {"objective": request.param, "grow_policy": "lossguide", "max_leaves": 12,
              "max_depth": 0, "max_bin": 32, "eta": 0.3, "min_child_weight": 5.0}
    if request.param == "multi:softprob":
        params["num_class"] = 3
    logs = _Log(), _Log()
    ours = train(params, DataMatrix(X, y), 3, evals=[(DataMatrix(Xv, yv), "validation")],
                 device="cpu", callbacks=[logs[0]], verbose_eval=False)
    ref = jax_booster.train(params, JaxDataMatrix(X, y), 3,
                            evals=[(JaxDataMatrix(Xv, yv), "validation")],
                            callbacks=[logs[1]], verbose_eval=False)
    return ours, ref, logs[0].log, logs[1].log, Xv


def test_train_lossguide_matches_jax(trained):
    ours, ref, log, ref_log, Xv = trained
    assert len(ours.trees) == len(ref.trees) and ours.tree_info == list(ref.tree_info)
    for a, b in zip(ours.trees, ref.trees):
        for key in ("feature", "threshold", "default_left", "left", "right"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
        np.testing.assert_allclose(a.value, b.value, atol=1e-5)
    # leaf-wise: more leaves than a depth-3 tree could have
    assert max(t.num_nodes for t in ours.trees) > 15
    np.testing.assert_allclose(ours.predict(Xv, output_margin=True),
                               ref.predict(Xv, output_margin=True), atol=1e-5)
    for metric, values in ref_log["validation"].items():
        np.testing.assert_allclose(log["validation"][metric], values, atol=1e-5)


def test_lossguide_models_cross_load(trained, tmp_path):
    ours, ref, _, _, Xv = trained
    ours.save_model(str(tmp_path / "port.json"))
    ref.save_model(str(tmp_path / "jax.json"))
    in_jax = JaxForest.load_model(str(tmp_path / "port.json"))
    np.testing.assert_allclose(in_jax.predict(Xv), ours.predict(Xv), atol=1e-5)
    in_port = Forest.load_model(str(tmp_path / "jax.json"), device="cpu")
    np.testing.assert_allclose(in_port.predict(Xv), ref.predict(Xv), atol=1e-5)


@pytest.mark.parametrize("params,match", [
    ({"grow_policy": "lossguide"}, "max_leaves >= 2"),
    ({"grow_policy": "lossguide", "max_leaves": 0}, "max_leaves >= 2"),
    ({"max_depth": 0}, "max_depth must be >= 1"),
    ({"grow_policy": "levelwise"}, "grow_policy='levelwise'"),
])
def test_train_config_rules(params, match):
    with pytest.raises(exc.UserError, match=match):
        TrainConfig(params)


def test_train_config_takes_lossguide():
    cfg = TrainConfig({"grow_policy": "lossguide", "max_leaves": 31, "max_depth": 0})
    assert (cfg.grow_policy, cfg.max_leaves, cfg.predict_depth) == ("lossguide", 31, 30)
    assert TrainConfig({"grow_policy": "lossguide", "max_leaves": 31,
                        "max_depth": 5}).predict_depth == 5
    assert TrainConfig({"max_depth": 7}).predict_depth == 7


def test_lossguide_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    X, score = _data(n=200)
    with pytest.raises(exc.UserError, match="cpu"):
        train({"grow_policy": "lossguide", "max_leaves": 4}, DataMatrix(X, score), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("classes", [1, 3])
def test_lossguide_on_cuda_matches_cpu(problem, classes):
    """The builder through the CUDA histogram kernels against the plain
    versions: the same trees on this well-separated problem."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this check on the card")
    bins, grad, hess, num_cuts, B = problem
    g, h = (grad[0], hess[0]) if classes == 1 else (grad, hess)
    kw = dict(max_leaves=31, max_depth=0, min_child_weight=5.0, num_bins=B)
    trees = {}
    for dev in ("cuda", "cpu"):
        tree, out = lossguide.build_tree_lossguide(
            *(torch.as_tensor(a, device=dev) for a in (bins, g, h, num_cuts)), **kw)
        trees[dev] = ({k: v.cpu() for k, v in tree.items()}, out.cpu())
    (tree, out), (ref, ref_out) = trees["cuda"], trees["cpu"]
    _assert_same_tree(tree, {k: v.numpy() for k, v in ref.items()}, out, ref_out.numpy())
