"""Port parity for the slice as a whole: ``train()``, the Forest codec,
prediction, model conversion, and the port's import and device rules."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest
from sagemaker_xgboost_container_tpu.ops import tree_build as jax_tb
from sagemaker_xgboost_container_tpu_torch import convert, train
from sagemaker_xgboost_container_tpu_torch.data.binning import bin_matrix
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models.booster import TrainConfig
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.ops import predict
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32, "eta": 0.3}


def _data(n=3000, d=9, seed=0, missing=0.05):
    """bench.py's synthetic binary task at a small size, with missing values."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    logit = X[:, 0] * 0.8 + X[:, 1] * X[:, 2] * 0.5 + np.sin(X[:, 3]) - 0.2
    y = (logit + rng.randn(n) * 0.5 > 0).astype(np.float32)
    X[rng.rand(n, d) < missing] = np.nan
    return X, y


class _Log:
    def __init__(self, stop_at=None):
        self.stop_at = stop_at
        self.log = None

    def after_iteration(self, forest, rnd, evals_log):
        self.log = evals_log
        return self.stop_at is not None and rnd >= self.stop_at


@pytest.fixture(scope="module")
def trained():
    X, y = _data()
    Xv, yv = _data(n=800, seed=1)
    log = _Log()
    ours = train(PARAMS, DataMatrix(X, y), 3, evals=[(DataMatrix(Xv, yv), "validation")],
                 device="cpu", callbacks=[log], verbose_eval=False)
    ref = jax_booster.train(PARAMS, JaxDataMatrix(X, y), 3,
                            evals=[(JaxDataMatrix(Xv, yv), "validation")])
    return ours, ref, log.log, Xv


def test_train_matches_jax(trained):
    ours, ref, log, Xv = trained
    assert len(ours.trees) == len(ref.trees) == 3
    for a, b in zip(ours.trees, ref.trees):
        for key in ("feature", "threshold", "default_left", "left", "right"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
        np.testing.assert_allclose(a.value, b.value, atol=1e-5)
    np.testing.assert_allclose(ours.predict(Xv), ref.predict(Xv), atol=1e-4)
    ll = log["validation"]["logloss"]
    assert len(ll) == 3 and ll[0] > ll[1] > ll[2]


def test_validation_logloss_matches_jax_metric(trained):
    from sagemaker_xgboost_container_tpu.models import eval_metrics

    ours, _, log, Xv = trained
    _, yv = _data(n=800, seed=1)
    want = eval_metrics.logloss(ours.predict(Xv), yv)
    assert abs(log["validation"]["logloss"][-1] - want) < 1e-5


def test_train_prints_metric_lines(capsys):
    X, y = _data(n=600)
    train(PARAMS, DataMatrix(X, y), 2, evals=[(DataMatrix(X, y), "train")], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split("\t")[0] for ln in lines] == ["[0]", "[1]"]
    assert lines[0].split("\t")[1].startswith("train-logloss:")


def test_callback_stops_training():
    X, y = _data(n=600)
    log = _Log(stop_at=1)
    forest = train(PARAMS, DataMatrix(X, y), 10, evals=[(DataMatrix(X, y), "train")],
                   device="cpu", callbacks=[log], verbose_eval=False)
    assert forest.num_boosted_rounds == 2
    assert len(log.log["train"]["logloss"]) == 2


def test_models_cross_load(trained, tmp_path):
    ours, ref, _, Xv = trained
    ours_path, ref_path = tmp_path / "port.json", tmp_path / "jax.json"
    ours.save_model(str(ours_path))
    ref.save_model(str(ref_path))
    # port model -> JAX package
    in_jax = JaxForest.load_model(str(ours_path))
    np.testing.assert_allclose(in_jax.predict(Xv), ours.predict(Xv), atol=1e-5)
    # JAX model -> port, both through the file and through convert
    in_port = Forest.load_model(str(ref_path), device="cpu")
    np.testing.assert_allclose(in_port.predict(Xv), ref.predict(Xv), atol=1e-5)
    converted = convert.forest_from_reference(ref.save_json(), device="cpu")
    np.testing.assert_allclose(converted.predict(Xv), ref.predict(Xv), atol=1e-5)
    assert json.loads(ours.save_json())["learner"]["objective"]["name"] == "binary:logistic"


def test_convert_from_padded_arrays():
    X, y = _data(n=1500, seed=5)
    binned = bin_matrix(DataMatrix(X, y), 32)
    grad = np.random.RandomState(6).randn(len(y)).astype(np.float32)
    tree, _ = jax_tb.build_tree(
        binned.bins, grad, np.ones_like(grad),
        np.asarray([len(c) for c in binned.cut_points], np.int32),
        max_depth=3, num_bins=binned.num_bins,
    )
    trees = [jax_tb.unpack_tree(np.asarray(jax_tb.pack_tree(tree)))] * 2
    ref = JaxForest(objective_name="reg:squarederror", num_feature=X.shape[1])
    from sagemaker_xgboost_container_tpu.models.forest import compact_padded_tree as jax_compact

    for t in trees:
        ref.append_round([jax_compact(t, binned.cut_points)], [0])
    ours = convert.forest_from_reference(
        {"trees": trees, "cut_points": binned.cut_points, "objective": "reg:squarederror",
         "num_feature": X.shape[1]},
        device="cpu",
    )
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), atol=1e-5)


def test_device_and_host_predict_agree(trained):
    ours, ref, _, Xv = trained
    host, stacked = ours._stack()
    dev = predict.forest_predict_margin(stacked, torch.as_tensor(Xv), base_margin=0.0)
    hst = predict.host_predict_margin(host, Xv, base_margin=0.0)
    np.testing.assert_allclose(dev.numpy(), hst, atol=1e-6)
    # tiny payloads take the host path; both agree with the JAX package
    np.testing.assert_allclose(ours.predict(Xv[:5]), ref.predict(Xv[:5]), atol=1e-5)
    np.testing.assert_allclose(ours.predict(Xv[:5], output_margin=True),
                               ref.predict(Xv[:5], output_margin=True), atol=1e-5)


@pytest.mark.parametrize("iteration_range", [None, (0, 1), (0, 2), (1, 3), (2, 0), (0, 0)])
@pytest.mark.parametrize("rows", [5, 200])
def test_iteration_range_matches_jax(trained, iteration_range, rows):
    _, ref, _, Xv = trained
    ours = Forest.from_dict(json.loads(ref.save_json()), device="cpu")
    for margin in (False, True):
        np.testing.assert_allclose(
            ours.predict(Xv[:rows], output_margin=margin, iteration_range=iteration_range),
            ref.predict(Xv[:rows], output_margin=margin, iteration_range=iteration_range),
            atol=1e-6)


def test_attr_and_set_attr_match_jax(trained):
    _, ref, _, _ = trained
    ours = Forest.from_dict(json.loads(ref.save_json()), device="cpu")
    mirror = JaxForest.load_json(ref.save_json())
    for forest in (ours, mirror):
        forest.set_attr(best_iteration=1, best_score=0.25)
        forest.set_attr(best_score=None)
    assert ours.attributes == mirror.attributes == {"best_iteration": "1"}
    assert ours.attr("best_iteration") == mirror.attr("best_iteration") == "1"
    assert ours.attr("missing") is None
    saved = Forest.load_json(ours.save_json(), device="cpu")
    assert saved.attr("best_iteration") == "1"


def test_predict_counts_host_and_device_paths(trained):
    from sagemaker_xgboost_container_tpu_torch.models import forest as forest_mod

    ours, _, _, Xv = trained
    forest_mod.reset_predict_counts()
    ours.predict(Xv[:forest_mod.HOST_PREDICT_ROWS])
    ours.predict(Xv[:forest_mod.HOST_PREDICT_ROWS + 1])
    ours.predict(Xv[:1], iteration_range=(0, 1))
    assert forest_mod.PREDICTS == {"host": 2, "device": 1}
    forest_mod.reset_predict_counts()
    assert forest_mod.PREDICTS == {"host": 0, "device": 0}


def test_stack_builds_each_slice_once_under_concurrency(trained, monkeypatch):
    """Concurrent first predicts (serving threads) build and upload each tree
    slice once; every thread gets the same stacked arrays."""
    _, ref, _, Xv = trained
    ours = Forest.from_dict(json.loads(ref.save_json()), device="cpu")
    builds = []
    real = Forest._stack_uncached

    def counting(self, trees):
        builds.append(len(trees))
        return real(self, trees)

    monkeypatch.setattr(Forest, "_stack_uncached", counting)
    from sagemaker_xgboost_container_tpu_torch.models import forest as forest_mod

    before = dict(forest_mod.PREDICTS)
    results, errors = [], []
    ranges = [None, (0, 2)]

    def hammer(i):
        try:
            for _ in range(20):
                rng = ranges[i % 2]
                results.append((rng, ours._stack(*((0, 2) if rng else ())),
                                ours.predict(Xv[:40], iteration_range=rng)))
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(i,)) for i in range(2 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert sorted(builds) == [2, 3]
    for rng, stacked, pred in results:
        assert stacked is ours._stack(*((0, 2) if rng else ()))
        np.testing.assert_allclose(pred, ref.predict(Xv[:40], iteration_range=rng), atol=1e-6)
    # no lost update of the shared counters
    assert forest_mod.PREDICTS["device"] - before["device"] == len(results)


@pytest.mark.parametrize(
    "params",
    [
        {"subsample": 0.8},
        {"colsample_bytree": 0.5},
        {"colsample_bylevel": 0.5},
        {"colsample_bynode": 0.5},
        {"grow_policy": "lossguide", "max_leaves": 8},
        {"objective": "rank:pairwise"},
        {"monotone_constraints": [1, 0]},
        {"interaction_constraints": [[0, 1]]},
        {"booster": "dart"},
        {"tree_method": "approx"},
        {"num_parallel_tree": 2},
        {"tree_method": "gpu_hist"},
    ],
)
def test_parameters_outside_the_slice_raise(params):
    """Refusals (tree_method=gpu_hist), and (since the port trains them)
    acceptance of lossguide with max_leaves, of the ranking objectives, of
    row and column sampling, of num_parallel_tree, of the dart booster, of
    the monotone and interaction constraints and of tree_method=approx."""
    name = next(iter(params))
    if name in ("grow_policy", "objective", "subsample", "colsample_bytree",
                "colsample_bylevel", "colsample_bynode", "num_parallel_tree", "booster",
                "monotone_constraints", "interaction_constraints") or params == {
                    "tree_method": "approx"}:
        config = TrainConfig(dict(PARAMS, **params))
        assert getattr(config, name) == params[name]
        return
    with pytest.raises(exc.UserError, match=name):
        TrainConfig(dict(PARAMS, **params))


def test_no_gpu_and_no_cpu_request_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    X, y = _data(n=100)
    with pytest.raises(exc.UserError, match="cpu"):
        train(PARAMS, DataMatrix(X, y), 1)
    with pytest.raises(exc.UserError):
        Forest()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "import sagemaker_xgboost_container_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sagemaker_xgboost_container_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.cuda
def test_train_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this check on the card")
    X, y = _data(n=5000)
    on_gpu = train(PARAMS, DataMatrix(X, y), 3, device="cuda", verbose_eval=False)
    on_cpu = train(PARAMS, DataMatrix(X, y), 3, device="cpu", verbose_eval=False)
    # splits may differ where gains tie exactly; the partitions do not
    np.testing.assert_allclose(on_gpu.predict(X), on_cpu.predict(X), atol=1e-4)
