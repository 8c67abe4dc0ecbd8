"""The port's ``train`` entry point against the JAX package's, on the CPU.

Both packages' ``sagemaker_train`` run over the same fabricated SageMaker
tree (channels, hyperparameters, checkpoint config) and must write models
with identical splits and leaf values within 1e-5, and print metric lines
of the same keys with values within 1e-5. The JAX side gets
``_num_devices=1``: the test harness gives JAX eight virtual CPU devices,
and its training would otherwise shard the rows over a mesh.

Where no training row with a missing value reaches a split, both placements
of the missing bucket score the same in exact arithmetic, and f32 rounding
(of the sibling-subtracted histograms) picks ``default_left``; the packages
round differently. So ``default_left`` is compared at the splits that rows
with a missing value reach, and only the training channel has missing
values (a validation row could otherwise follow an undecided default).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu.data import readers as jax_readers
from sagemaker_xgboost_container_tpu.models import device_metrics as jax_device_metrics
from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest
from sagemaker_xgboost_container_tpu_torch.models import device_metrics
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, checkpointing, entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, N_VAL, D = 3000, 600, 9
BASE_HP = {"num_round": "6", "max_depth": "4", "max_bin": "32", "eta": "0.3",
           "objective": "binary:logistic", "eval_metric": "logloss,auc"}
METRIC_LINE = re.compile(r"^\[(\d+)\]\t(.*)$")


def _jax(module):
    """A JAX-package module that needs sklearn or protobuf, which the GPU
    machine lacks: imported by the CPU tests that use it, so that the
    ``cuda`` tests collect there."""
    import importlib

    return importlib.import_module("sagemaker_xgboost_container_tpu." + module)


@pytest.fixture(autouse=True)
def _private_jax_staging(tmp_path, monkeypatch):
    """The JAX reader stages every channel into one fixed directory; give it
    one of this test's own, so that parallel test workers do not share it."""
    stage = jax_readers.stage_input_files
    monkeypatch.setattr(jax_readers, "stage_input_files",
                        lambda path: stage(path, staging_dir=str(tmp_path / "jax_stage")))


def _data(n, seed, missing=0.05):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, D), 4).astype(np.float32)
    logit = X[:, 0] * 0.8 + X[:, 1] * X[:, 2] * 0.5 + np.sin(X[:, 3]) - 0.2
    y = (logit + rng.randn(n) * 0.5 > 0).astype(np.float32)
    X[rng.rand(n, D) < missing] = np.nan
    return X, y


def _write_channel(path, X, y, kind):
    os.makedirs(path)
    if kind == "csv":
        with open(os.path.join(path, "data.csv"), "w") as f:
            for label, row in zip(y, X):
                f.write(",".join([repr(float(label))] + ["" if np.isnan(v) else repr(float(v))
                                                         for v in row]) + "\n")
    elif kind == "libsvm":
        with open(os.path.join(path, "data.libsvm"), "w") as f:
            for label, row in zip(y, X):
                f.write(" ".join([repr(float(label))] + ["{}:{!r}".format(j, float(v))
                                                         for j, v in enumerate(row)
                                                         if not np.isnan(v)]) + "\n")
    else:
        with open(os.path.join(path, "data.rec"), "wb") as f:
            f.write(_jax("data.recordio").write_recordio_protobuf(X, y))


CONTENT_TYPES = {"csv": "text/csv", "libsvm": "text/libsvm",
                 "recordio": "application/x-recordio-protobuf"}


def _tree(root, kind="csv", seed=0):
    """Fabricate train/validation channels -> dict of sagemaker_train's
    path arguments."""
    X, y = _data(N, seed)
    X_val, y_val = _data(N_VAL, seed + 100, missing=0.0)
    train, val = os.path.join(root, "train"), os.path.join(root, "validation")
    _write_channel(train, X, y, kind)
    _write_channel(val, X_val, y_val, kind)
    channel = {"ContentType": CONTENT_TYPES[kind], "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    return {"data_config": {"train": channel, "validation": dict(channel)},
            "train_path": train, "val_path": val, "X": X}


def _run(package, tree, hp, model_dir, capsys, checkpoint_dir=None):
    """sagemaker_train of one package -> (model, {round: {key: value}})."""
    kw = dict(train_config=dict(hp), model_dir=model_dir, sm_hosts=["algo-1"],
              sm_current_host="algo-1",
              checkpoint_config={"LocalPath": checkpoint_dir} if checkpoint_dir else {},
              **{k: v for k, v in tree.items() if k != "X"})
    capsys.readouterr()
    if package == "port":
        algorithm_train.sagemaker_train(device="cpu", **kw)
    else:
        kw["train_config"]["_num_devices"] = "1"
        _jax("training.algorithm_train").sagemaker_train(**kw)
    lines = {}
    for line in capsys.readouterr().out.splitlines():
        m = METRIC_LINE.match(line)
        if m:
            lines[int(m.group(1))] = {k: float(v) for k, v in
                                      (part.split(":") for part in m.group(2).split("\t"))}
    return Forest.load_model(os.path.join(model_dir, "xgboost-model"), device="cpu"), lines


def _missing_reaches(tree, X):
    """Per node: does a row of X with a missing value in the node's split
    feature reach it?"""
    out = np.zeros(tree.num_nodes, bool)
    stack = [(0, np.ones(len(X), bool))]
    while stack:
        node, rows = stack.pop()
        if tree.is_leaf[node]:
            continue
        v = X[:, tree.feature[node]]
        out[node] = bool(np.isnan(v[rows]).any())
        right = np.where(np.isnan(v), ~tree.default_left[node], v >= tree.threshold[node])
        stack += [(tree.left[node], rows & ~right), (tree.right[node], rows & right)]
    return out


def _assert_same_forest(a, b, X, tol=1e-5):
    """Identical splits (``default_left`` where rows of X with a missing
    value reach the split) and leaf values within ``tol``."""
    assert len(a.trees) == len(b.trees)
    assert a.iteration_indptr == b.iteration_indptr
    for ta, tb in zip(a.trees, b.trees):
        np.testing.assert_array_equal(ta.left, tb.left)
        split = ~ta.is_leaf
        np.testing.assert_array_equal(ta.feature[split], tb.feature[split])
        np.testing.assert_array_equal(ta.threshold[split], tb.threshold[split])
        decided = _missing_reaches(ta, X)
        np.testing.assert_array_equal(ta.default_left[decided], tb.default_left[decided])
        np.testing.assert_allclose(ta.value[ta.is_leaf], tb.value[tb.is_leaf], atol=tol)


def _assert_same_lines(a, b):
    assert sorted(a) == sorted(b)
    for rnd in a:
        assert list(a[rnd]) == list(b[rnd]), rnd
        for key in a[rnd]:
            # both print 5 decimals: a value on a rounding edge may differ
            # in the last printed digit
            assert abs(a[rnd][key] - b[rnd][key]) <= 1e-5 + 1e-12, (rnd, key)


@pytest.mark.parametrize("kind", ["csv", "libsvm", "recordio"])
def test_sagemaker_train_matches_jax(kind, tmp_path, capsys):
    tree = _tree(str(tmp_path), kind)
    ours, our_lines = _run("port", tree, BASE_HP, str(tmp_path / "model_port"), capsys)
    ref, ref_lines = _run("jax", tree, BASE_HP, str(tmp_path / "model_jax"), capsys)
    _assert_same_forest(ours, ref, tree["X"])
    _assert_same_lines(our_lines, ref_lines)
    assert sorted(our_lines) == list(range(6))
    assert list(our_lines[0]) == ["train-logloss", "train-auc", "validation-logloss",
                                  "validation-auc"]


@pytest.mark.parametrize("hp", [
    {"tree_method": "approx", "interaction_constraints": "[[0,1],[2,3,4,5,6,7]]"},
    # depth 3: with a bin a distinct value, deeper nodes of these 3,000 rows
    # hold near-ties of adjacent thresholds that f32 sums decide
    {"tree_method": "exact", "monotone_constraints": "(1,0,-1)", "max_depth": "3"},
    {"tree_method": "hist", "monotone_constraints": "(1,0,-1)",
     "interaction_constraints": "[[0,1],[2,3]]"},
])
def test_sagemaker_train_tree_methods_and_constraints_match_jax(hp, tmp_path, capsys):
    """hyperparameters.json strings of the constraints and the exact and
    approx tree methods, through both packages' entry points: the same
    model and metric lines."""
    tree = _tree(str(tmp_path), "csv", seed=6)
    hp = dict(BASE_HP, **hp)
    ours, our_lines = _run("port", tree, hp, str(tmp_path / "model_port"), capsys)
    ref, ref_lines = _run("jax", tree, hp, str(tmp_path / "model_jax"), capsys)
    _assert_same_forest(ours, ref, tree["X"])
    _assert_same_lines(our_lines, ref_lines)
    assert sorted(our_lines) == list(range(6))
    if "interaction_constraints" in hp:
        sets = [set(s) for s in json.loads(hp["interaction_constraints"])]
        for t in ours.trees:
            stack = [(0, set())]
            while stack:
                node, used = stack.pop()
                if t.is_leaf[node]:
                    assert any(used <= s for s in sets), used
                    continue
                used = used | {int(t.feature[node])}
                stack += [(t.left[node], used), (t.right[node], used)]


@pytest.mark.parametrize("metric", ["validation:logloss", "validation:auc"])
def test_early_stopping_with_save_best_matches_jax(metric, tmp_path, capsys):
    """Noisy labels, many rounds and a high eta: training stops early and the
    saved model is cut to the best iteration, in both packages alike."""
    tree = _tree(str(tmp_path), "csv", seed=3)
    hp = dict(BASE_HP, num_round="60", eta="0.9", max_depth="6",
              early_stopping_rounds="3", _tuning_objective_metric=metric)
    ours, our_lines = _run("port", tree, hp, str(tmp_path / "model_port"), capsys)
    ref, ref_lines = _run("jax", tree, hp, str(tmp_path / "model_jax"), capsys)
    _assert_same_lines(our_lines, ref_lines)
    best = int(ours.attr("best_iteration"))
    assert best == int(ref.attr("best_iteration"))
    assert max(our_lines) == best + 3 < 59  # stopped early, 3 rounds after the best
    assert ours.num_boosted_rounds == best + 1
    _assert_same_forest(ours, ref, tree["X"])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [7, 500, 20000])
def test_auc_matches_jax_device_metric(seed, n):
    """Weighted AUC with many tied predictions, against the JAX device metric."""
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    m = np.round(rng.randn(n) * 1.5, 1).astype(np.float32)  # ties
    y = (rng.rand(n) < 0.35).astype(np.float32)
    w = (rng.rand(n) * 2).astype(np.float32)
    ref = jax_device_metrics.make_device_metric("auc", "binary:logistic", 1)
    want = float(ref.finalize(ref.partial(jnp.asarray(m), jnp.asarray(y), jnp.asarray(w))))
    ours = device_metrics.make_device_metric("auc", "binary:logistic")
    got = float(ours(torch.as_tensor(m), torch.as_tensor(y), torch.as_tensor(w)))
    assert abs(got - want) <= 1e-6


def _checkpoints(path):
    return sorted(int(n.rsplit(".", 1)[1]) for n in os.listdir(path)
                  if re.match(r"^xgboost-checkpoint\.\d+$", n))


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    tree = _tree(str(tmp_path), "csv", seed=4)
    hp = dict(BASE_HP, num_round="8")
    whole, whole_lines = _run("port", tree, hp, str(tmp_path / "whole"), capsys)
    ckpt = str(tmp_path / "ckpt")
    _run("port", tree, hp, str(tmp_path / "first"), capsys, checkpoint_dir=ckpt)
    assert _checkpoints(ckpt) == [3, 4, 5, 6, 7]  # max_to_keep = 5
    for i in (5, 6, 7):
        os.remove(os.path.join(ckpt, "xgboost-checkpoint.{}".format(i)))
    # a corrupt newest checkpoint is skipped in favour of the one before it
    with open(os.path.join(ckpt, "xgboost-checkpoint.5"), "w") as f:
        f.write('{"learner": ')
    resumed, lines = _run("port", tree, hp, str(tmp_path / "second"), capsys, checkpoint_dir=ckpt)
    assert sorted(lines) == [5, 6, 7]
    _assert_same_forest(resumed, whole, tree["X"])
    for rnd in lines:
        assert lines[rnd] == pytest.approx(whole_lines[rnd], abs=1e-5)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_checkpoints_resume_across_packages(writer, reader, tmp_path, capsys):
    """Four rounds checkpointed by one package, four more by the other: the
    model equals the reader's own uninterrupted eight rounds."""
    tree = _tree(str(tmp_path), "csv", seed=5)
    ckpt = str(tmp_path / "ckpt")
    _run(writer, tree, dict(BASE_HP, num_round="4"), str(tmp_path / "first"), capsys,
         checkpoint_dir=ckpt)
    assert _checkpoints(ckpt) == [0, 1, 2, 3]
    resumed, lines = _run(reader, tree, dict(BASE_HP, num_round="8"), str(tmp_path / "second"),
                          capsys, checkpoint_dir=ckpt)
    assert sorted(lines) == [4, 5, 6, 7]
    whole, _ = _run(reader, tree, dict(BASE_HP, num_round="8"), str(tmp_path / "whole"), capsys)
    _assert_same_forest(resumed, whole, tree["X"])
    assert JaxForest.load_model(os.path.join(str(tmp_path / "second"), "xgboost-model"))


def test_checkpointing_retention_and_temp_files(tmp_path):
    forest = Forest(device="cpu")
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    (tmp_path / "ckpt" / "junk.sagemaker-ignore").write_text("x")
    (tmp_path / "ckpt" / "xgboost-checkpoint.2.manifest").write_text("{}")
    assert checkpointing.load_checkpoint(ckpt) == (None, 0)
    # the temp file and the manifest without its checkpoint are both swept
    assert os.listdir(ckpt) == []
    saver = checkpointing.SaveCheckpointCallBack(ckpt, max_to_keep=2, num_round=6)
    for epoch in range(6):
        saver.after_iteration(forest, epoch, {})
    saver.stop()
    assert _checkpoints(ckpt) == [4, 5]
    assert checkpointing.load_checkpoint(ckpt) == (os.path.join(ckpt, "xgboost-checkpoint.5"), 6)


def _sm_env(monkeypatch, tmp_path, hp, data_config, train=True):
    tree = _tree(str(tmp_path), "csv")
    conf = tmp_path / "config"
    conf.mkdir()
    (conf / "hyperparameters.json").write_text(json.dumps(hp))
    (conf / "inputdataconfig.json").write_text(json.dumps(data_config))
    env = {"SM_INPUT_TRAINING_CONFIG_FILE": str(conf / "hyperparameters.json"),
           "SM_INPUT_DATA_CONFIG_FILE": str(conf / "inputdataconfig.json"),
           "SM_CHECKPOINT_CONFIG_FILE": str(conf / "checkpointconfig.json"),
           "SM_CHANNEL_VALIDATION": tree["val_path"],
           "SM_MODEL_DIR": str(tmp_path / "model"),
           "SM_OUTPUT_DATA_DIR": str(tmp_path / "output" / "data"),
           "SM_HOSTS": '["algo-1"]', "SM_CURRENT_HOST": "algo-1"}
    if train:
        env["SM_CHANNEL_TRAIN"] = tree["train_path"]
    for key in list(os.environ):
        if key.startswith("SM_CHANNEL_") or key in ("SM_OUTPUT_DIR", "SAGEMAKER_PROGRAM"):
            monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    return tree


def _main(module, monkeypatch, tmp_path, name, **kw):
    """main() of one package in this process -> (exit code, failure file)."""
    failure = str(tmp_path / "failure-{}".format(name))
    monkeypatch.setattr(module, "FAILURE_FILE", failure)
    derive = module.derive_sm_env
    monkeypatch.setattr(module, "derive_sm_env",
                        lambda: derive(input_root=str(tmp_path / "no_opt_ml")))
    with pytest.raises(SystemExit) as e:
        module.main(**kw)
    text = open(failure).read() if os.path.exists(failure) else None
    return e.value.code, text


# a user script of script mode: the port's sklearn estimator on the csv
# train channel, the model saved into SM_MODEL_DIR
SKLEARN_SCRIPT = """
import argparse, os
import numpy as np
from sagemaker_xgboost_container_tpu_torch.sklearn import TorchXGBRegressor

parser = argparse.ArgumentParser()
parser.add_argument("--num_round", type=int)
parser.add_argument("--max_depth", type=int)
args, _ = parser.parse_known_args()
rows = np.genfromtxt(os.path.join(os.environ["SM_CHANNEL_TRAIN"], "data.csv"), delimiter=",",
                     dtype=np.float32)
model = TorchXGBRegressor(n_estimators=args.num_round, max_depth=args.max_depth, device="cpu")
model.fit(rows[:, 1:], rows[:, 0])
os.makedirs(os.environ["SM_MODEL_DIR"], exist_ok=True)
model.save_model(os.path.join(os.environ["SM_MODEL_DIR"], "xgboost-model"))
"""

CSV_CHANNELS = {c: {"ContentType": "csv", "TrainingInputMode": "File",
                    "S3DistributionType": "FullyReplicated"} for c in ("train", "validation")}


@pytest.mark.parametrize("case", ["missing_train_channel", "bad_content_type",
                                  "invalid_hyperparameter", "missing_train_config"])
def test_main_failure_file_matches_jax(case, monkeypatch, tmp_path):
    hp, channels, train = dict(BASE_HP), json.loads(json.dumps(CSV_CHANNELS)), True
    if case == "missing_train_channel":
        train = False
        del channels["train"]
    elif case == "bad_content_type":
        channels["train"]["ContentType"] = "application/json"
    elif case == "invalid_hyperparameter":
        hp["max_depth"] = "-2"
    else:
        del channels["train"]
    _sm_env(monkeypatch, tmp_path, hp, channels, train=train)
    ours = _main(entry, monkeypatch, tmp_path, "port", device="cpu")
    ref = _main(_jax("training.entry"), monkeypatch, tmp_path, "jax")
    assert ours == ref
    assert ours[0] == 1 and ours[1].startswith("Customer Error")


def test_main_trains_on_the_cpu_when_asked(monkeypatch, tmp_path, capsys):
    _sm_env(monkeypatch, tmp_path, BASE_HP, CSV_CHANNELS)
    code, failure = _main(entry, monkeypatch, tmp_path, "port", device="cpu")
    assert (code, failure) == (0, None)
    assert os.path.exists(str(tmp_path / "model" / "xgboost-model"))
    out = capsys.readouterr().out
    # the HPO regex (a real tab here, #011 in CloudWatch)
    assert len(re.findall(r".*\[[0-9]+\].*\tvalidation-auc:(\S+)", out)) == 6


def test_entry_module_needs_a_gpu(tmp_path):
    """``python -m ...training.entry`` trains on CUDA: without a GPU it exits
    1 and its failure file says why."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tree = _tree(str(tmp_path), "csv")
    conf = tmp_path / "config"
    conf.mkdir()
    (conf / "hyperparameters.json").write_text(json.dumps(BASE_HP))
    (conf / "inputdataconfig.json").write_text(json.dumps(CSV_CHANNELS))
    env = dict(os.environ, PYTHONPATH=REPO, SM_OUTPUT_DIR=str(tmp_path / "output"),
               SM_INPUT_TRAINING_CONFIG_FILE=str(conf / "hyperparameters.json"),
               SM_INPUT_DATA_CONFIG_FILE=str(conf / "inputdataconfig.json"),
               SM_CHECKPOINT_CONFIG_FILE=str(conf / "checkpointconfig.json"),
               SM_CHANNEL_TRAIN=tree["train_path"], SM_CHANNEL_VALIDATION=tree["val_path"],
               SM_MODEL_DIR=str(tmp_path / "model"), SM_HOSTS='["algo-1"]',
               SM_CURRENT_HOST="algo-1", SM_OUTPUT_DATA_DIR=str(tmp_path / "output" / "data"))
    out = subprocess.run([sys.executable, "-m", "sagemaker_xgboost_container_tpu_torch.training.entry"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1, out.stderr[-2000:]
    failure = (tmp_path / "output" / "failure").read_text()
    assert failure.startswith("Customer Error") and "no CUDA device" in failure
    assert not os.path.exists(str(tmp_path / "model" / "xgboost-model"))


@pytest.mark.parametrize("case,match", [
    ("kfold", r"k-fold cross-validation \(_kfold\)"),
    ("multi_host", None),
    ("script_mode", "script mode"),
    ("parquet", "parquet"),
    ("custom_metric", "custom metrics.*accuracy"),
    ("booster", "booster='dart'"),
])
def test_left_out_paths_raise_user_error_naming_them(case, match, tmp_path, monkeypatch):
    """k-fold CV, parquet channels, the custom metrics, script mode and
    booster=dart run to their models; k-fold CV across two hosts is no
    longer refused, and goes on to contact its peer
    (``tests/test_torch_distributed_options.py`` runs it on two hosts)."""
    tree = _tree(str(tmp_path), "csv")
    hp, hosts = dict(BASE_HP), ["algo-1"]
    if case == "kfold":
        hp["_kfold"] = "3"
    elif case == "multi_host":
        # k-fold CV across two hosts trains: past the checks, the job waits
        # for its peer's name to resolve
        hosts = ["algo-1", "algo-2"]
        hp["_kfold"] = "3"

        class PeerContacted(Exception):
            pass

        def contacted(hosts):
            raise PeerContacted(hosts)

        monkeypatch.setattr(algorithm_train.distributed, "wait_hostname_resolution",
                            contacted)
        with pytest.raises(PeerContacted):
            algorithm_train.sagemaker_train(hp, tree["data_config"], tree["train_path"],
                                            tree["val_path"], str(tmp_path / "model"), hosts,
                                            "algo-1", {}, device="cpu")
        return
    elif case == "parquet":
        pa = pytest.importorskip("pyarrow")
        import pyarrow.parquet as pq

        os.makedirs(str(tmp_path / "pq"))
        X, y = _data(N, 0)
        pq.write_table(pa.table([pa.array(y)] + [pa.array(X[:, j]) for j in range(X.shape[1])],
                                names=["y"] + ["f{}".format(j) for j in range(X.shape[1])]),
                       str(tmp_path / "pq" / "a.parquet"))
        tree = {"data_config": {"train": dict(CSV_CHANNELS["train"],
                                              ContentType="application/x-parquet")},
                "train_path": str(tmp_path / "pq"), "val_path": None}
    elif case == "custom_metric":
        hp["eval_metric"] = "accuracy"
    elif case == "booster":
        hp["booster"] = "dart"
    if case in ("kfold", "parquet", "custom_metric", "booster"):
        monkeypatch.setenv("SM_OUTPUT_DATA_DIR", str(tmp_path / "output"))
        algorithm_train.sagemaker_train(hp, tree["data_config"], tree["train_path"],
                                        tree["val_path"], str(tmp_path / "model"), hosts,
                                        "algo-1", {}, device="cpu")
        names = ["xgboost-model-{}".format(k) for k in range(3)] if case == "kfold" else [
            "xgboost-model"]
        # each model with its manifest, as the JAX package writes them
        assert sorted(os.listdir(str(tmp_path / "model"))) == sorted(
            names + [n + ".manifest" for n in names])
        return
    if case == "script_mode":
        code = tmp_path / "code"
        code.mkdir()
        (code / "train.py").write_text(SKLEARN_SCRIPT)
        monkeypatch.setenv("PYTHONPATH", REPO)
        _sm_env(monkeypatch, tmp_path / "sm", dict(hp, sagemaker_program="train.py",
                                                   sagemaker_submit_directory=str(code)),
                CSV_CHANNELS)
        entry.train(device="cpu")
        assert os.listdir(str(tmp_path / "sm" / "model")) == ["xgboost-model"]
        return
    with pytest.raises(exc.UserError, match=match):
        algorithm_train.sagemaker_train(hp, tree["data_config"], tree["train_path"],
                                        tree["val_path"], str(tmp_path / "model"), hosts,
                                        "algo-1", {}, device="cpu")


def test_sagemaker_train_needs_cuda_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tree = _tree(str(tmp_path), "csv")
    with pytest.raises(exc.UserError, match="no CUDA device"):
        algorithm_train.sagemaker_train(dict(BASE_HP), tree["data_config"], tree["train_path"],
                                        tree["val_path"], str(tmp_path / "model"), ["algo-1"],
                                        "algo-1", {})


@pytest.mark.cuda
def test_entry_on_cuda_matches_cpu(tmp_path, capsys):
    """sagemaker_train on the GPU against the same run on the CPU: the same
    metric keys and rounds, predictions within 1e-4 (the GPU's f32 atomic
    histograms may break exact gain ties another way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this check on the card")
    tree = _tree(str(tmp_path), "csv")
    out = {}
    for device in ("cuda", "cpu"):
        capsys.readouterr()
        model_dir = str(tmp_path / device)
        algorithm_train.sagemaker_train(dict(BASE_HP), tree["data_config"], tree["train_path"],
                                        tree["val_path"], model_dir, ["algo-1"], "algo-1", {},
                                        device=device)
        lines = [line for line in capsys.readouterr().out.splitlines() if METRIC_LINE.match(line)]
        out[device] = (Forest.load_model(os.path.join(model_dir, "xgboost-model"), device="cpu"),
                       lines)
    assert [line.split("\t")[0] for line in out["cuda"][1]] == \
        [line.split("\t")[0] for line in out["cpu"][1]]
    X, _ = _data(2000, seed=9)
    np.testing.assert_allclose(out["cuda"][0].predict(X), out["cpu"][0].predict(X), atol=1e-4)
