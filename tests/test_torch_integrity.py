"""The port's model-artifact integrity (``utils/integrity.py`` and the
verified loads of ``serving/serve_utils.py``) held against the JAX
package's on the CPU: the forest digest of one model file in both packages
(a JAX-written and a port-written model), manifests that each package
writes and the other verifies, and digest, parse and structure failures
counted per stage in both registries.

Models are trained from a numpy seed at a small size (depth <= 4, a few
rounds) by the JAX package and by the port on the CPU.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models import compat as jax_compat
from sagemaker_xgboost_container_tpu.serving import serve_utils as jax_serve_utils
from sagemaker_xgboost_container_tpu.telemetry import REGISTRY as JAX_REGISTRY
from sagemaker_xgboost_container_tpu.utils import integrity as jax_integrity
from sagemaker_xgboost_container_tpu_torch import train as port_train
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import compat
from sagemaker_xgboost_container_tpu_torch.serving import serve_utils
from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY
from sagemaker_xgboost_container_tpu_torch.utils import integrity

D = 6


def _data(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, D).astype(np.float32)
    X[rng.rand(n, D) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) ** 2 > 0.3).astype(np.float32)
    return X, y


PARAMS = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32, "eta": 0.3}
MULTI = {"objective": "multi:softprob", "num_class": 3, "max_depth": 3, "max_bin": 16}


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """{kind: path} of xgboost JSON model files: written by the JAX package
    (binary and 3-class) and by the port on the CPU (binary)."""
    root = tmp_path_factory.mktemp("integrity")
    X, y = _data(800, seed=0)
    out = {}
    jax_bin = jax_booster.train(PARAMS, JaxDataMatrix(X, y), 4)
    yc = np.digitize(np.nan_to_num(X[:, 2]), [-0.4, 0.4]).astype(np.float32)
    jax_multi = jax_booster.train(MULTI, JaxDataMatrix(X, yc), 2)
    port_bin = port_train(PARAMS, DataMatrix(X, y), 4, device="cpu", verbose_eval=False)
    for kind, forest in (("jax", jax_bin), ("jax-multiclass", jax_multi), ("port", port_bin)):
        d = root / kind
        d.mkdir()
        forest.save_model(str(d / "xgboost-model"))
        out[kind] = str(d / "xgboost-model")
    return out


def _copy(path, tmp_path, name="m"):
    d = tmp_path / name
    d.mkdir()
    dst = str(d / "xgboost-model")
    shutil.copyfile(path, dst)
    return dst


def _count(registry, name, **labels):
    for family, _kind, _help, series in registry.collect():
        if family == name:
            for metric in series:
                if metric.labels == labels:
                    return metric.value
    return 0.0


# ------------------------------------------------------------------ digests

@pytest.mark.parametrize("kind", ["jax", "jax-multiclass", "port"])
def test_forest_digest_equal_across_packages(model_files, kind):
    """One model file, loaded by each package: the same hex digest (the
    same fields, dtypes and order over both Forests)."""
    path = model_files[kind]
    ours = compat.load_model_any_format(path, device="cpu")[0]
    ref = jax_compat.load_model_any_format(path)[0]
    digest = integrity.forest_digest(ours)
    assert digest == jax_integrity.forest_digest(ref)
    assert len(digest) == 64 and int(digest, 16) >= 0


def test_forest_digest_sees_one_bit(model_files, tmp_path):
    """A threshold one ulp away, or a flipped default direction, is another
    digest in both packages."""
    path = _copy(model_files["jax"], tmp_path)
    base = integrity.forest_digest(compat.load_model_any_format(path, device="cpu")[0])
    forest = compat.load_model_any_format(path, device="cpu")[0]
    split = int(np.nonzero(forest.trees[0].left >= 0)[0][0])
    forest.trees[0].threshold[split] = np.nextafter(forest.trees[0].threshold[split],
                                                    np.float32(np.inf))
    assert integrity.forest_digest(forest) != base
    forest = compat.load_model_any_format(path, device="cpu")[0]
    forest.trees[0].default_left[split] = not forest.trees[0].default_left[split]
    assert integrity.forest_digest(forest) != base


def test_file_digest_matches_jax(model_files):
    for path in model_files.values():
        assert integrity.file_digest(path) == jax_integrity.file_digest(path)


# ---------------------------------------------------------------- manifests

@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["jax", "port"])
def test_manifest_written_by_one_verifies_in_the_other(model_files, tmp_path, writer, kind):
    path = _copy(model_files[kind], tmp_path)
    (jax_integrity if writer == "jax" else integrity).write_manifest(path, iteration=3)
    assert integrity.check_model_file(path) == "verified"
    assert jax_integrity.check_model_file(path) == "verified"
    assert integrity.read_manifest(path) == jax_integrity.read_manifest(path)
    # the sidecar is never listed as a model, and the dot-temp never lingers
    assert sorted(os.listdir(os.path.dirname(path))) == ["xgboost-model",
                                                         "xgboost-model.manifest"]
    assert list(serve_utils._get_full_model_paths(os.path.dirname(path))) == [path]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tampered_file_fails_at_digest_in_both(model_files, tmp_path, writer):
    """One flipped byte after the manifest was written: both packages raise
    at the digest stage and count it once."""
    path = _copy(model_files["jax"], tmp_path)
    (jax_integrity if writer == "jax" else integrity).write_manifest(path)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(integrity.IntegrityError, match="sha256"):
        integrity.check_model_file(path)
    with pytest.raises(jax_integrity.IntegrityError, match="sha256"):
        jax_integrity.check_model_file(path)
    before = (_count(REGISTRY, "model_verify_fail_total", stage="digest"),
              _count(JAX_REGISTRY, "model_verify_fail_total", stage="digest"))
    with pytest.raises(integrity.IntegrityError, match="digest verification"):
        serve_utils.get_loaded_booster(os.path.dirname(path), device="cpu")
    with pytest.raises(jax_integrity.IntegrityError, match="digest verification"):
        jax_serve_utils.get_loaded_booster(os.path.dirname(path))
    after = (_count(REGISTRY, "model_verify_fail_total", stage="digest"),
             _count(JAX_REGISTRY, "model_verify_fail_total", stage="digest"))
    assert (after[0] - before[0], after[1] - before[1]) == (1.0, 1.0)


def test_truncated_file_fails_at_digest_by_byte_count(model_files, tmp_path):
    path = _copy(model_files["port"], tmp_path)
    integrity.write_manifest(path)
    with open(path, "ab") as f:
        f.write(b" ")
    for mod in (integrity, jax_integrity):
        with pytest.raises(mod.IntegrityError, match="byte count"):
            mod.check_model_file(path)


@pytest.mark.parametrize("sidecar", [
    "{not json", json.dumps({"bytes": 3}), json.dumps({"sha256": "ab", "bytes": "many"}),
    json.dumps(["sha256"])])
def test_malformed_manifest_is_ignored_in_both(model_files, tmp_path, sidecar):
    """A sidecar that does not parse, lacks the digest or has a garbage byte
    count is no manifest in both packages: the load falls back to the parse
    and structure checks."""
    path = _copy(model_files["jax"], tmp_path)
    with open(path + ".manifest", "w") as f:
        f.write(sidecar)
    assert integrity.read_manifest(path) is None
    assert jax_integrity.read_manifest(path) is None
    assert integrity.check_model_file(path) == jax_integrity.check_model_file(path) == \
        "no_manifest"
    forest, fmt = serve_utils.get_loaded_booster(os.path.dirname(path), device="cpu")
    assert fmt == "xgb_format" and len(forest.trees) == 4


def test_drift_baseline_is_read_and_ignored_once(model_files, tmp_path, monkeypatch):
    """With SM_MODEL_TELEMETRY unset a manifest's drift baseline is read
    and ignored, load after load, in both packages: no drift window."""
    from sagemaker_xgboost_container_tpu.telemetry import model as jax_model_telemetry
    from sagemaker_xgboost_container_tpu_torch.telemetry import model as model_telemetry

    monkeypatch.delenv(model_telemetry.MODEL_TELEMETRY_ENV, raising=False)
    model_telemetry._reset_for_tests()
    jax_model_telemetry._reset_for_tests()
    path = _copy(model_files["jax"], tmp_path)
    jax_integrity.write_manifest(path, drift_baseline={
        "version": 1, "rows": 2, "features": [{"cuts": [0.0], "fracs": [0.5, 0.5, 0.0]}]})
    for _ in range(2):
        forest, _ = serve_utils.get_loaded_booster(os.path.dirname(path), device="cpu")
        jax_serve_utils.get_loaded_booster(os.path.dirname(path))
    assert model_telemetry.active_drift() is None
    assert jax_model_telemetry.active_drift() is None
    assert len(forest.trees) == 4


def test_ensemble_dir_with_manifests_loads_every_model(model_files, tmp_path):
    d = tmp_path / "ensemble"
    d.mkdir()
    for i, kind in enumerate(("jax", "port")):
        dst = str(d / "model-{}".format(i))
        shutil.copyfile(model_files[kind], dst)
        integrity.write_manifest(dst)
    models, formats = serve_utils.get_loaded_booster(str(d), ensemble=True, device="cpu")
    ref_models, _ = jax_serve_utils.get_loaded_booster(str(d), ensemble=True)
    assert len(models) == len(ref_models) == 2 and formats == ["xgb_format"] * 2
    assert [integrity.forest_digest(m) for m in models] == [
        jax_integrity.forest_digest(m) for m in ref_models]


# --------------------------------------------------------- parse, structure

def _corrupt(path, kind):
    """Edit the model JSON at ``path`` in place; -> the stage it fails at."""
    if kind == "garbage":
        with open(path, "wb") as f:
            f.write(b"not a model at all")
        return "parse"
    with open(path) as f:
        doc = json.load(f)
    model = doc["learner"]["gradient_booster"]["model"]
    tree = model["trees"][0]
    split = next(i for i, c in enumerate(tree["left_children"]) if c >= 0)
    if kind == "child-out-of-range":
        tree["left_children"][split] = 10_000
    elif kind == "self-loop":
        tree["right_children"][split] = split
    elif kind == "nan-threshold":
        tree["split_conditions"][split] = float("nan")
    elif kind == "inf-leaf":
        leaf = next(i for i, c in enumerate(tree["left_children"]) if c < 0)
        tree["split_conditions"][leaf] = float("inf")
    elif kind == "feature-out-of-range":
        tree["split_indices"][split] = D + 5
    elif kind == "one-child":
        tree["right_children"][split] = -1
    elif kind == "tree-info":
        model["tree_info"] = model["tree_info"][:-1]
    elif kind == "class-id":
        model["tree_info"][0] = 7
    elif kind == "indptr":
        model["iteration_indptr"] = [0, 2, 1, len(model["trees"])]
    with open(path, "w") as f:
        json.dump(doc, f)
    return "structure"


CORRUPTIONS = ["garbage", "child-out-of-range", "self-loop", "nan-threshold", "inf-leaf",
               "feature-out-of-range", "one-child", "tree-info", "class-id", "indptr"]


@pytest.mark.parametrize("kind", CORRUPTIONS)
def test_corrupt_model_fails_its_stage_in_both(model_files, tmp_path, kind):
    """Each corruption fails the verified load of both packages at the same
    stage and counts there once; no stage counts anything else."""
    path = _copy(model_files["jax"], tmp_path)
    stage = _corrupt(path, kind)
    stages = ("digest", "parse", "structure")
    before = [(_count(REGISTRY, "model_verify_fail_total", stage=s),
               _count(JAX_REGISTRY, "model_verify_fail_total", stage=s)) for s in stages]
    with pytest.raises(Exception) as ours:
        serve_utils.get_loaded_booster(os.path.dirname(path), device="cpu")
    with pytest.raises(Exception) as ref:
        jax_serve_utils.get_loaded_booster(os.path.dirname(path))
    after = [(_count(REGISTRY, "model_verify_fail_total", stage=s),
              _count(JAX_REGISTRY, "model_verify_fail_total", stage=s)) for s in stages]
    delta = {s: (a[0] - b[0], a[1] - b[1]) for s, a, b in zip(stages, after, before)}
    assert delta == {s: (1.0, 1.0) if s == stage else (0.0, 0.0) for s in stages}, delta
    if stage == "structure":
        assert isinstance(ours.value, integrity.IntegrityError)
        assert isinstance(ref.value, jax_integrity.IntegrityError)


@pytest.mark.parametrize("kind", [k for k in CORRUPTIONS if k != "garbage"])
def test_validate_model_matches_jax(model_files, tmp_path, kind):
    """validate_model of the port's Forest raises where the JAX one does,
    naming the same tree."""
    path = _copy(model_files["jax"], tmp_path)
    _corrupt(path, kind)
    ours = compat.load_model_any_format(path, device="cpu")[0]
    ref = jax_compat.load_model_any_format(path)[0]
    with pytest.raises(integrity.IntegrityError) as a:
        integrity.validate_model(ours)
    with pytest.raises(jax_integrity.IntegrityError) as b:
        jax_integrity.validate_model(ref)
    assert str(a.value).split(":")[0] == str(b.value).split(":")[0]


@pytest.mark.parametrize("kind", ["jax", "jax-multiclass", "port"])
def test_valid_models_validate_in_both(model_files, kind):
    ours = compat.load_model_any_format(model_files[kind], device="cpu")[0]
    integrity.validate_model(ours)
    integrity.validate_model([ours, ours])
    jax_integrity.validate_model(jax_compat.load_model_any_format(model_files[kind])[0])


# ------------------------------------------------ fingerprints and resumes
TRAIN_CFG = {"objective": "binary:logistic", "tree_method": "hist", "max_bin": 32,
             "max_depth": 4}


def test_fingerprints_differ_in_jax_version_only():
    from sagemaker_xgboost_container_tpu_torch import __version__
    from sagemaker_xgboost_container_tpu import __version__ as jax_package_version

    ours = integrity.config_fingerprint(TRAIN_CFG)
    ref = jax_integrity.config_fingerprint(TRAIN_CFG)
    assert ours["jax_version"] == "absent" and ref["jax_version"] != "absent"
    assert ours["torch_version"] and "torch_version" not in ref
    assert __version__ == jax_package_version == ours["package_version"]
    want = [("jax_version", ref["jax_version"], "absent")]
    assert integrity.fingerprint_mismatches(ref, ours) == want
    assert jax_integrity.fingerprint_mismatches(ref, ours) == want
    assert integrity.fingerprint_mismatches(ours, ref) == [(k, b, a) for k, a, b in want]
    assert integrity.fingerprint_mismatches(ours, dict(ours, torch_version="0")) == [
        ("torch_version", ours["torch_version"], "0")]


def _checkpoint(writer, ckpt, forest):
    from sagemaker_xgboost_container_tpu.training import checkpointing as jax_checkpointing
    from sagemaker_xgboost_container_tpu_torch.training import checkpointing

    ck, integ = ((checkpointing, integrity) if writer == "port"
                 else (jax_checkpointing, jax_integrity))
    saver = ck.SaveCheckpointCallBack(ckpt, fingerprint=integ.config_fingerprint(TRAIN_CFG))
    saver.after_iteration(forest, 0, {})
    saver.stop()
    return os.path.join(ckpt, "xgboost-checkpoint.0")


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_resume_across_packages_warns_and_strict_refuses(model_files, tmp_path, monkeypatch,
                                                         caplog, writer, reader):
    """A checkpoint of one package resumes under the other's
    ``get_callbacks``: its digest verifies, the runtime change in
    ``jax_version`` warns, and under SM_RESUME_STRICT=true it refuses,
    naming the key."""
    from sagemaker_xgboost_container_tpu.toolkit import exceptions as jax_exc
    from sagemaker_xgboost_container_tpu.training import callbacks as jax_callbacks
    from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
    from sagemaker_xgboost_container_tpu_torch.training import callbacks

    monkeypatch.delenv(integrity.RESUME_STRICT_ENV, raising=False)
    forest = compat.load_model_any_format(model_files["port"], device="cpu")[0]
    path = _checkpoint(writer, str(tmp_path / "ckpt"), forest)
    integ, cbs, err = ((integrity, callbacks, exc) if reader == "port"
                       else (jax_integrity, jax_callbacks, jax_exc))
    assert integ.check_model_file(path) == "verified"
    live = integ.config_fingerprint(TRAIN_CFG)
    kwargs = dict(model_dir=str(tmp_path / "model"), checkpoint_dir=str(tmp_path / "ckpt"),
                  early_stopping_data_name=None, early_stopping_metric=None,
                  early_stopping_rounds=None, save_model_on_termination="false",
                  is_master=False, train_cfg=TRAIN_CFG)
    with caplog.at_level(logging.WARNING):
        assert integ.validate_resume(path, live) is False
        xgb_model, iteration, _cbs = cbs.get_callbacks(**kwargs)
    assert (xgb_model, iteration) == (path, 1)
    assert any("jax_version" in r.getMessage() for r in caplog.records)
    monkeypatch.setenv(integrity.RESUME_STRICT_ENV, "true")
    with pytest.raises(err.UserError, match="jax_version"):
        cbs.get_callbacks(**kwargs)
    same = _checkpoint(reader, str(tmp_path / "own"), forest)
    assert integ.validate_resume(same, live) is True


@pytest.mark.parametrize("key,value", [("max_depth", 7), ("objective", "reg:squarederror"),
                                       ("max_bin", 64)])
def test_strict_resume_refuses_a_changed_config_naming_it(tmp_path, monkeypatch, model_files,
                                                          key, value):
    from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc

    forest = compat.load_model_any_format(model_files["port"], device="cpu")[0]
    path = _checkpoint("port", str(tmp_path / "ckpt"), forest)
    live = integrity.config_fingerprint(dict(TRAIN_CFG, **{key: value}))
    monkeypatch.delenv(integrity.RESUME_STRICT_ENV, raising=False)
    assert integrity.validate_resume(path, live) is False
    monkeypatch.setenv(integrity.RESUME_STRICT_ENV, "true")
    with pytest.raises(exc.UserError, match=key):
        integrity.validate_resume(path, live)
    assert integrity.validate_resume(None, live) is True


def test_final_model_manifests_verify_across_packages(model_files, tmp_path, monkeypatch):
    """The port's final model and its manifest (fingerprint, and under
    SM_MODEL_TELEMETRY the learning summary and drift baseline) verify
    under the JAX package's check, and the JAX package's under the port's."""
    from sagemaker_xgboost_container_tpu_torch.telemetry import model as model_telemetry
    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train

    monkeypatch.setenv(model_telemetry.MODEL_TELEMETRY_ENV, "true")
    model_telemetry._reset_for_tests()
    try:
        X, y = _data(400, seed=2)
        forest = port_train(PARAMS, DataMatrix(X, y), 2, device="cpu", verbose_eval=False)
        model_telemetry.note_eval(1, "validation", "logloss", 0.5)
        path = str(tmp_path / "xgboost-model")
        algorithm_train._save_with_manifest(forest, path, TRAIN_CFG)
        manifest = jax_integrity.read_manifest(path)
        assert jax_integrity.check_model_file(path) == "verified"
        assert manifest["fingerprint"] == integrity.config_fingerprint(TRAIN_CFG)
        assert manifest["learning"]["best_iteration"] == 1
        assert manifest["drift_baseline"]["rows"] == 400
        jax_path = _copy(model_files["jax"], tmp_path, "jaxmodel")
        jax_integrity.write_manifest(jax_path, fingerprint=jax_integrity.config_fingerprint(
            TRAIN_CFG))
        assert integrity.check_model_file(jax_path) == "verified"
    finally:
        model_telemetry._reset_for_tests()


def test_manifest_write_failure_only_warns(tmp_path, monkeypatch, caplog, model_files):
    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train

    forest = compat.load_model_any_format(model_files["port"], device="cpu")[0]

    def refuse(*args, **kwargs):
        raise OSError("read-only volume")

    monkeypatch.setattr(integrity, "write_manifest", refuse)
    path = str(tmp_path / "xgboost-model")
    with caplog.at_level(logging.WARNING):
        algorithm_train._save_with_manifest(forest, path, TRAIN_CFG)
    assert os.path.isfile(path) and not os.path.exists(path + ".manifest")
    assert any("could not write model manifest" in r.getMessage() for r in caplog.records)
