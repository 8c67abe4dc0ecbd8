"""Port parity for multiclass training (multi:softmax, multi:softprob).

The port grows a round's C trees in one level loop on [C, n] gradients; the
JAX package vmaps its builder over the classes. On a fixture whose best
split gains are well separated, both must commit the same trees class by
class, with leaf values and mlogloss/merror within 1e-5; their models load
in each other and predict alike; a resumed run equals an uninterrupted one
tree for tree; and the SageMaker entry point trains a multiclass job.
"""

import os
import re

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest
from sagemaker_xgboost_container_tpu.ops import tree_build as jax_tb
from sagemaker_xgboost_container_tpu_torch import convert, train
from sagemaker_xgboost_container_tpu_torch.data.binning import bin_matrix
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.training import algorithm_train

C = 3
PARAMS = {"num_class": C, "max_depth": 4, "max_bin": 32, "eta": 0.3,
          "eval_metric": ["mlogloss", "merror"]}
METRIC_LINE = re.compile(r"^\[(\d+)\]\t(.*)$")


def _data(n, seed):
    """Three classes from noisy per-class scores of 9 features."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 9).astype(np.float32)
    score = np.stack([X[:, 0] * 1.5, X[:, 1] * 1.2 + X[:, 2],
                      -X[:, 0] + np.sin(X[:, 3]) * 2], axis=1)
    y = np.argmax(score + rng.randn(n, C) * 0.5, axis=1).astype(np.float32)
    return X, y


class _Log:
    def after_iteration(self, model, epoch, evals_log):
        self.log = evals_log
        return False


@pytest.fixture(scope="module", params=["multi:softmax", "multi:softprob"])
def trained(request):
    X, y = _data(3000, 0)
    Xv, yv = _data(800, 1)
    params = dict(PARAMS, objective=request.param)
    ours_log, ref_log = _Log(), _Log()
    ours = train(params, DataMatrix(X, y), 3, evals=[(DataMatrix(Xv, yv), "validation")],
                 device="cpu", callbacks=[ours_log], verbose_eval=False)
    ref = jax_booster.train(params, JaxDataMatrix(X, y), 3,
                            evals=[(JaxDataMatrix(Xv, yv), "validation")],
                            callbacks=[ref_log], verbose_eval=False)
    return ours, ref, ours_log.log, ref_log.log, Xv


def test_trees_match_jax_class_by_class(trained):
    ours, ref, _, _, _ = trained
    assert ours.num_class == ref.num_class == C
    assert ours.tree_info == ref.tree_info == [0, 1, 2] * 3
    assert ours.iteration_indptr == ref.iteration_indptr == [0, 3, 6, 9]
    for a, b in zip(ours.trees, ref.trees):
        for key in ("feature", "threshold", "default_left", "left", "right"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
        np.testing.assert_allclose(a.value, b.value, atol=1e-5)


def test_metrics_match_jax(trained):
    _, _, log, ref_log, _ = trained
    for metric in ("mlogloss", "merror"):
        ours, ref = log["validation"][metric], ref_log["validation"][metric]
        assert len(ours) == 3
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    ll = log["validation"]["mlogloss"]
    assert ll[0] > ll[1] > ll[2]


def test_models_cross_load_and_predict_alike(trained, tmp_path):
    ours, ref, _, _, Xv = trained
    np.testing.assert_allclose(ours.predict(Xv), ref.predict(Xv), atol=1e-5)
    np.testing.assert_allclose(ours.predict(Xv, output_margin=True),
                               ref.predict(Xv, output_margin=True), atol=1e-5)
    ours_path, ref_path = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    ours.save_model(ours_path)
    ref.save_model(ref_path)
    in_jax = JaxForest.load_model(ours_path)
    assert in_jax.num_class == C and in_jax.tree_info == ours.tree_info
    np.testing.assert_allclose(in_jax.predict(Xv), ours.predict(Xv), atol=1e-5)
    in_port = Forest.load_model(ref_path, device="cpu")
    np.testing.assert_allclose(in_port.predict(Xv), ref.predict(Xv), atol=1e-5)


def test_resumed_run_equals_uninterrupted(trained):
    ours, _, _, _, _ = trained
    X, y = _data(3000, 0)
    params = dict(PARAMS, objective=ours.objective_name)
    first = train(params, DataMatrix(X, y), 2, device="cpu", verbose_eval=False)
    resumed = train(params, DataMatrix(X, y), 1, device="cpu", verbose_eval=False,
                    xgb_model=first)
    assert resumed.num_boosted_rounds == 3 and resumed.tree_info == ours.tree_info
    for a, b in zip(resumed.trees, ours.trees):
        for key in ("feature", "threshold", "default_left", "left", "right", "value"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key


def test_convert_multi_output_padded_arrays():
    import jax
    import jax.numpy as jnp

    X, y = _data(1500, 5)
    binned = bin_matrix(DataMatrix(X, y), 32)
    rng = np.random.RandomState(6)
    grad = rng.randn(C, len(y)).astype(np.float32)
    hess = (rng.rand(C, len(y)) + 0.5).astype(np.float32)
    num_cuts = jnp.asarray(np.asarray([len(c) for c in binned.cut_points], np.int32))
    tree, _ = jax.vmap(lambda g, h: jax_tb.build_tree(
        jnp.asarray(binned.bins), g, h, num_cuts, max_depth=3, num_bins=binned.num_bins))(
        jnp.asarray(grad), jnp.asarray(hess))
    round_arrays = jax_tb.unpack_tree(np.asarray(jax_tb.pack_tree(tree)))  # [C, nodes]
    ref = JaxForest(objective_name="multi:softprob", num_class=C, num_feature=X.shape[1])
    from sagemaker_xgboost_container_tpu.models.forest import compact_padded_tree as jax_compact

    for _ in range(2):
        ref.append_round([jax_compact({k: v[c] for k, v in round_arrays.items()},
                                      binned.cut_points) for c in range(C)], list(range(C)))
    ours = convert.forest_from_reference(
        {"trees": [round_arrays] * 2, "cut_points": binned.cut_points,
         "objective": "multi:softprob", "num_feature": X.shape[1], "num_class": C},
        device="cpu",
    )
    assert ours.tree_info == ref.tree_info == [0, 1, 2] * 2
    assert ours.num_class == C
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), atol=1e-5)


def _write_csv(path, X, y):
    os.makedirs(path)
    with open(os.path.join(path, "data.csv"), "w") as f:
        for label, row in zip(y, X):
            f.write(",".join([repr(float(label))] + [repr(float(v)) for v in row]) + "\n")


def _sagemaker_train(tmp_path, hp, capsys, shift=0.0):
    """sagemaker_train on csv channels of the 3-class data, labels + shift."""
    X, y = _data(2000, 7)
    Xv, yv = _data(500, 8)
    y, yv = y + shift, yv + shift
    train_dir, val_dir = str(tmp_path / "train"), str(tmp_path / "validation")
    _write_csv(train_dir, X, y)
    _write_csv(val_dir, Xv, yv)
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    model_dir = str(tmp_path / "model")
    capsys.readouterr()
    algorithm_train.sagemaker_train(
        dict(hp), {"train": channel, "validation": dict(channel)}, train_dir, val_dir,
        model_dir, ["algo-1"], "algo-1", {}, device="cpu")
    lines = [METRIC_LINE.match(line) for line in capsys.readouterr().out.splitlines()]
    metrics = [dict(part.split(":") for part in m.group(2).split("\t")) for m in lines if m]
    return Forest.load_model(os.path.join(model_dir, "xgboost-model"), device="cpu"), metrics


def test_sagemaker_entry_point_trains_multiclass(tmp_path, capsys):
    hp = {"num_round": "30", "max_depth": "4", "max_bin": "32", "eta": "0.5",
          "objective": "multi:softprob", "num_class": "3", "eval_metric": "mlogloss,merror",
          "early_stopping_rounds": "3", "_tuning_objective_metric": "validation:merror"}
    model, metrics = _sagemaker_train(tmp_path, hp, capsys)
    assert model.num_class == 3 and model.objective_name == "multi:softprob"
    assert len(model.trees) == 3 * model.num_boosted_rounds
    # one HPO line a round, with the validation metrics the tuner scrapes
    assert len(metrics) >= 4
    for line in metrics:
        assert {"validation-mlogloss", "validation-merror"} <= set(line)
    merror = [float(line["validation-merror"]) for line in metrics]
    # early stopping on validation:merror, minimised: it stops 3 rounds
    # after the lowest merror and keeps every round up to the stop
    best = int(np.argmin(merror))
    assert len(merror) == 30 or len(merror) == best + 4
    assert merror[best] < merror[0]


@pytest.mark.parametrize("objective,metric", [
    ("multi:softmax", "merror"), ("count:poisson", "poisson-nloglik"),
    ("reg:pseudohubererror", "mphe"), ("survival:aft", "aft-nloglik"),
])
def test_default_metric_reaches_the_hpo_lines(tmp_path, capsys, objective, metric):
    # one round a dispatch: mphe and aft-nloglik have no device form, and
    # under the entry point's default K the host evaluates them once a
    # dispatch, where this test reads a line a round
    hp = {"num_round": "2", "max_depth": "3", "max_bin": "16", "objective": objective,
          "_rounds_per_dispatch": "1"}
    if objective.startswith("multi:"):
        hp["num_class"] = "3"
    # class ids, or (for the others) class ids + 1: positive counts and times
    model, metrics = _sagemaker_train(tmp_path, hp, capsys,
                                      shift=0.0 if "num_class" in hp else 1.0)
    assert model.num_boosted_rounds == 2
    assert len(metrics) == 2
    for line in metrics:
        assert set(line) == {"train-" + metric, "validation-" + metric}
        assert all(np.isfinite(float(v)) for v in line.values())
