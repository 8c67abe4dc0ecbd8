"""The port's model formats and Booster API held against the JAX package on
the CPU: categorical splits (predict, pred_leaf and the numpy host path),
the categorical JSON codec, get_score / get_dump, UBJSON save, legacy
binary files, pickled Boosters, digests and structural validation, and
process_type=update / xgb_model= from a categorical model.

Margins are compared within 1e-6 relative, leaf ids, dumps, importances
and digests exactly. The legacy-binary and pickle writers are
``chip_smoke.py``'s (published C structs, pickle opcodes; no xgboost
here).
"""

import json
import pickle
import sys

import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models import compat as jax_compat
from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest
from sagemaker_xgboost_container_tpu.models.forest import Tree as JaxTree
from sagemaker_xgboost_container_tpu.ops import predict as jax_predict
from sagemaker_xgboost_container_tpu.utils import integrity as jax_integrity
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import booster, compat
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.ops import predict
from sagemaker_xgboost_container_tpu_torch.utils import integrity
from chip_smoke import config_offset, legacy_binary, pickled_booster
from tests.test_categorical import CASES, _categorical_forest
from tests.test_torch_categorical_cuda import cat_rows as _cat_rows
from tests.test_torch_categorical_cuda import random_cat_trees

RTOL = 1e-6
ATOL = 1e-6

def _port(jax_forest):
    return Forest.load_json(jax_forest.save_json(), device="cpu")


def _random_cat_forest(seed, num_class=0, **kwargs):
    """``random_cat_trees`` as a JAX forest."""
    groups = max(1, num_class)
    trees = [JaxTree(**t) for t in random_cat_trees(seed, groups=groups, **kwargs)]
    forest = JaxForest(objective_name="multi:softprob" if num_class else "reg:squarederror",
                       base_score=0.5, num_feature=5, num_class=num_class)
    forest.trees = trees
    forest.tree_info = [i % groups for i in range(len(trees))]
    forest.iteration_indptr = list(range(0, len(trees) + 1, groups))
    return forest


# ------------------------------------------------------------ categorical


def test_categorical_hand_checked_cases():
    """The JAX package's hand-checked cases: margins, leaf ids and the host
    path of both packages."""
    ref = _categorical_forest()
    ours = _port(ref)
    X = np.asarray([c[0] for c in CASES], np.float32)
    want = np.asarray([c[1] for c in CASES], np.float32)
    np.testing.assert_allclose(ours.predict(X, output_margin=True), want, atol=ATOL)
    np.testing.assert_array_equal(ours.predict(X, pred_leaf=True), ref.predict(X, pred_leaf=True))
    host, dev = ours._stack()
    np.testing.assert_array_equal(
        predict.host_leaf_nodes(host, X),
        jax_predict.host_leaf_nodes(ref._stack(slice(0, 1)), X))
    np.testing.assert_array_equal(
        predict.forest_leaf_nodes(dev, torch.as_tensor(X)).numpy(),
        predict.host_leaf_nodes(host, X))


@pytest.mark.parametrize("seed,rows,num_class", [(0, 20, 0), (1, 300, 0), (2, 500, 0),
                                                 (3, 17, 3), (4, 400, 3)])
def test_random_categorical_forest_matches_jax(seed, rows, num_class):
    """Seeded random categorical forests on rows with invalid categories:
    margins within 1e-6, pred_leaf equal, and the numpy host path equal to
    the torch path and to the JAX host path."""
    ref = _random_cat_forest(seed, num_class=num_class)
    ours = _port(ref)
    X = _cat_rows(seed + 10, rows)
    np.testing.assert_allclose(ours.predict(X, output_margin=True),
                               ref.predict(X, output_margin=True), rtol=RTOL, atol=ATOL)
    leaf = ours.predict_leaf(X)
    assert leaf.dtype == np.int32 and leaf.shape == (rows, len(ref.trees))
    np.testing.assert_array_equal(leaf, ref.predict_leaf(X))
    np.testing.assert_array_equal(ours.predict_leaf(X, iteration_range=(1, 3)),
                                  ref.predict_leaf(X, iteration_range=(1, 3)))
    host, _dev = ours._stack()
    assert host["cat_mask"].dtype == np.int32
    np.testing.assert_array_equal(host["cat_mask"].view(np.uint32),
                                  ref._stack(slice(0, len(ref.trees)))["cat_mask"])
    np.testing.assert_array_equal(predict.host_leaf_nodes(host, X), leaf)
    np.testing.assert_array_equal(
        predict.host_leaf_nodes(host, X),
        jax_predict.host_leaf_nodes(ref._stack(slice(0, len(ref.trees))), X))


def test_categorical_rule_on_bit_31_and_float_edges():
    """One node, right-set {31, 32, 63}: bit 31 of word 0 (a negative int32
    word), the first bit of word 1, and the float edges around them."""
    tree = JaxTree(feature=[0, 0, 0], threshold=[0, 0, 0], default_left=[False, False, False],
                   left=[1, -1, -1], right=[2, -1, -1], value=[0, -1, 1],
                   categories={0: [31, 32, 63]})
    ref = JaxForest(base_score=0.0, num_feature=1)
    ref.trees, ref.tree_info, ref.iteration_indptr = [tree], [0], [0, 1]
    ours = _port(ref)
    x = np.asarray([31, 31.9, 32, 63, 63.99, 64, 30.99, -0.5, -0.0, 3e9, np.inf, -np.inf,
                    np.nan], np.float32)[:, None]
    want = np.asarray([1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1, 1], np.float32)
    X = np.repeat(x, 4, axis=0)  # 52 rows: the torch path
    np.testing.assert_array_equal(ours.predict(x, output_margin=True), want)
    np.testing.assert_array_equal(ours.predict(X, output_margin=True), np.repeat(want, 4))
    np.testing.assert_array_equal(ref.predict(X, output_margin=True), np.repeat(want, 4))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_categorical_json_round_trip(direction):
    ref = _random_cat_forest(5)
    if direction == "jax_to_port":
        ours = _port(ref)
        assert ours.save_json() == ref.save_json()
    else:
        ours = _port(ref)
        back = JaxForest.load_json(ours.save_json())
        assert back.save_json() == ref.save_json()
    tree = json.loads(ours.save_json())["learner"]["gradient_booster"]["model"]["trees"][0]
    assert len(tree["categories_nodes"]) == len(tree["categories_segments"]) == len(
        tree["categories_sizes"])
    assert [tree["split_type"][i] for i in tree["categories_nodes"]] == [1] * len(
        tree["categories_nodes"])
    assert all(t.has_categorical == r.has_categorical for t, r in zip(ours.trees, ref.trees))
    assert [t.max_category() for t in ours.trees] == [t.max_category() for t in ref.trees]


def test_numerical_forest_stacks_no_masks():
    ours = _port(jax_booster.train({"max_depth": 3, "max_bin": 16},
                                   JaxDataMatrix(*_reg_rows(200)), 2))
    host, dev = ours._stack()
    assert "cat_split" not in host and "cat_split" not in dev


def test_release_and_to_drop_the_masks():
    ours = _port(_random_cat_forest(6))
    _host, dev = ours._stack()
    assert "cat_mask" in dev and dev["cat_mask"].dtype == torch.int32
    ours.release()
    assert ours._stacked == {}
    ours._stack()
    ours.to("cpu")
    assert ours._stacked == {}


# ------------------------------------------------------- importances, dumps


def _reg_rows(n, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] * X[:, 2] + rng.randn(n) * 0.1).astype(np.float32)
    return X, y


def _trained(names=None):
    X, y = _reg_rows(500)
    dm = JaxDataMatrix(X, labels=y)
    if names:
        dm.feature_names = names
    return jax_booster.train({"max_depth": 4, "max_bin": 32, "eta": 0.3}, dm, 4)


@pytest.mark.parametrize("model", ["trained", "named", "categorical"])
@pytest.mark.parametrize("importance_type",
                         ["weight", "gain", "cover", "total_gain", "total_cover"])
def test_get_score_matches_jax(model, importance_type):
    ref = {"trained": lambda: _trained(), "named": lambda: _trained(list("abcdef")),
           "categorical": lambda: _random_cat_forest(7)}[model]()
    ours = _port(ref)
    assert ours.get_score(importance_type) == ref.get_score(importance_type)
    if importance_type == "weight":
        assert ours.get_fscore() == ref.get_fscore()


@pytest.mark.parametrize("model", ["trained", "named", "categorical", "hand"])
@pytest.mark.parametrize("with_stats", [False, True])
def test_get_dump_byte_equal(model, with_stats):
    ref = {"trained": lambda: _trained(), "named": lambda: _trained(list("abcdef")),
           "categorical": lambda: _random_cat_forest(8),
           "hand": _categorical_forest}[model]()
    ours = _port(ref)
    assert ours.get_dump(with_stats=with_stats) == ref.get_dump(with_stats=with_stats)


def test_get_score_rejects_unknown_type():
    from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc

    with pytest.raises(exc.UserError, match="importance_type"):
        _port(_trained()).get_score("shap")


# ------------------------------------------------------------------- UBJ


@pytest.mark.parametrize("how", ["extension", "explicit"])
def test_ubj_save_loads_in_the_other_package(tmp_path, how):
    ref = _random_cat_forest(9)
    ours = _port(ref)
    if how == "extension":
        mine, theirs = tmp_path / "port.ubj", tmp_path / "jax.ubj"
        ours.save_model(str(mine))
        ref.save_model(str(theirs))
    else:
        mine, theirs = tmp_path / "port-model", tmp_path / "jax-model"
        ours.save_model(str(mine), model_format="ubj")
        ref.save_model(str(theirs), model_format="ubj")
    assert mine.read_bytes() == theirs.read_bytes()
    assert mine.read_bytes()[:1] == b"{" and mine.read_bytes()[1:2] != b'"'
    loaded_ref, tag = jax_compat.load_model_any_format(str(mine))
    loaded_ours, our_tag = compat.load_model_any_format(str(theirs), device="cpu")
    assert tag == our_tag == "xgb_format"
    X = _cat_rows(1, 100)
    np.testing.assert_allclose(loaded_ours.predict(X), loaded_ref.predict(X), rtol=RTOL,
                               atol=ATOL)
    (tmp_path / "plain.json").write_text("")
    ours.save_model(str(tmp_path / "plain.json"))
    assert (tmp_path / "plain.json").read_text() == ref.save_json()


# ------------------------------------------------------------ legacy binary


def _same_forest(ours, ref):
    assert ours.objective_name == ref.objective_name
    assert ours.base_score == ref.base_score
    assert (ours.num_feature, ours.num_class) == (ref.num_feature, ref.num_class)
    assert ours.tree_info == ref.tree_info
    assert ours.iteration_indptr == ref.iteration_indptr
    assert ours.attributes == ref.attributes
    assert ours.feature_names == ref.feature_names
    assert len(ours.trees) == len(ref.trees)
    for a, b in zip(ours.trees, ref.trees):
        for field in ("feature", "threshold", "default_left", "left", "right", "value",
                      "base_weight", "gain", "sum_hess", "parent"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


def _multiclass_model():
    rng = np.random.RandomState(3)
    X = rng.randn(400, 5).astype(np.float32)
    y = rng.randint(0, 3, 400).astype(np.float32)
    X[:, 0] += y
    return jax_booster.train({"objective": "multi:softprob", "num_class": 3, "max_depth": 3,
                              "max_bin": 16}, JaxDataMatrix(X, labels=y), 3), X


@pytest.mark.parametrize("case", ["binf", "plain", "multiclass", "groups_zero", "attributes",
                                  "dart"])
def test_legacy_binary_parsed_by_both(case, tmp_path):
    if case in ("multiclass", "groups_zero"):
        model, X = _multiclass_model()
    else:
        model, X = _trained(), _reg_rows(80, seed=4)[0]
    kwargs = {"binf": case != "plain"}
    if case == "groups_zero":
        kwargs["num_output_group"] = 0  # falls back to num_class
    if case == "attributes":
        kwargs["attributes"] = {"best_iteration": "2", "note": "ok"}
    if case == "dart":
        kwargs["booster_name"] = "dart"
    raw = legacy_binary(model, **kwargs)
    assert raw[:4] == b"binf" if case != "plain" else raw[:4] != b"binf"
    path = tmp_path / "xgboost-model"
    path.write_bytes(raw)
    ours, tag = compat.load_model_any_format(str(path), device="cpu")
    ref, ref_tag = jax_compat.load_model_any_format(str(path))
    assert tag == ref_tag == "xgb_format"
    _same_forest(ours, ref)
    if case == "attributes":
        assert ours.attributes == {"best_iteration": "2", "note": "ok"}
    if case in ("multiclass", "groups_zero"):
        assert ours.tree_info == [i % 3 for i in range(len(model.trees))]
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.predict(X), model.predict(X), rtol=RTOL, atol=ATOL)


def test_legacy_gblinear_refused_by_both(tmp_path):
    path = tmp_path / "xgboost-model"
    path.write_bytes(legacy_binary(_trained(), booster_name="gblinear"))
    with pytest.raises(RuntimeError, match="booster 'gblinear' is not supported"):
        compat.load_model_any_format(str(path), device="cpu")
    with pytest.raises(RuntimeError, match="booster 'gblinear' is not supported"):
        jax_compat.load_model_any_format(str(path))


# ---------------------------------------------------------------- pickles


def _handle(kind, model):
    if kind == "json":
        return model.save_json().encode()
    if kind == "ubj":
        return jax_compat.encode_ubjson(json.loads(model.save_json()))
    return config_offset(legacy_binary(model), model.objective_name)


@pytest.mark.parametrize("kind", ["json", "ubj", "config_offset"])
@pytest.mark.parametrize("stub", ["port", "jax"])
def test_pickled_booster_matches_jax(kind, stub, tmp_path, monkeypatch):
    """Pickles whose handle holds JSON, UBJ or the CONFIG-offset legacy
    bytes; feature_names and best_iteration come from the pickled state.
    Either package's stub module may be the one installed first."""
    for name in ("xgboost", "xgboost.core", "xgboost.sklearn"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    (compat if stub == "port" else jax_compat)._install_xgboost_stub()
    model = _trained()
    path = tmp_path / "xgboost-model"
    path.write_bytes(pickled_booster(_handle(kind, model), feature_names=list("uvwxyz"),
                                     best_iteration=2))
    ours, tag = compat.load_model_any_format(str(path), device="cpu")
    ref, ref_tag = jax_compat.load_model_any_format(str(path))
    assert tag == ref_tag == "pkl_format"
    _same_forest(ours, ref)
    assert ours.feature_names == list("uvwxyz") and ours.attr("best_iteration") == "2"
    X = _reg_rows(60, seed=5)[0]
    np.testing.assert_allclose(ours.predict(X), model.predict(X), rtol=RTOL, atol=ATOL)


def test_pickle_without_handle_is_refused(tmp_path):
    path = tmp_path / "xgboost-model"
    path.write_bytes(pickle.dumps({"not": "a booster"}))
    with pytest.raises(RuntimeError, match="cannot be loaded"):
        compat.load_model_any_format(str(path), device="cpu")
    with pytest.raises(RuntimeError, match="cannot be loaded"):
        jax_compat.load_model_any_format(str(path))


# ---------------------------------------------------- digests, validation


def test_digest_equal_with_categories(tmp_path):
    ref = _random_cat_forest(12)
    path = tmp_path / "xgboost-model"
    path.write_text(ref.save_json())
    ours = compat.load_model_any_format(str(path), device="cpu")[0]
    theirs = jax_compat.load_model_any_format(str(path))[0]
    assert integrity.forest_digest(ours) == jax_integrity.forest_digest(theirs)
    # the sets are hashed: moving one category changes the digest
    t = next(i for i, tree in enumerate(ours.trees) if tree.has_categorical)
    node = sorted(ours.trees[t].categories)[0]
    for model in (ours, theirs):
        model.trees[t].categories[node] = np.append(model.trees[t].categories[node], 69)
    assert integrity.forest_digest(ours) == jax_integrity.forest_digest(theirs)
    assert integrity.forest_digest(ours) != integrity.forest_digest(_port(ref))


@pytest.mark.parametrize("where,valid", [("categorical", True), ("numerical", False)])
def test_validate_model_nan_threshold(where, valid):
    ref = _categorical_forest()  # node 0 categorical, node 1 numerical
    ref.trees[0].threshold[0 if where == "categorical" else 1] = np.nan
    ours = _port(ref)
    assert np.isnan(ours.trees[0].threshold).any()
    if valid:
        integrity.validate_model(ours)
        jax_integrity.validate_model(ref)
        return
    with pytest.raises(integrity.IntegrityError, match="non-finite split threshold"):
        integrity.validate_model(ours)
    with pytest.raises(jax_integrity.IntegrityError, match="non-finite split threshold"):
        jax_integrity.validate_model(ref)


# ------------------------------------------- update / resume from categories


def _coded_rows(n=800, seed=0):
    """Feature 0 a category code 0..9 that drives the label."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    X[:, 0] = rng.randint(0, 10, n)
    y = (np.where(np.isin(X[:, 0], [1, 4, 7]), 2.0, -1.0) + X[:, 1]
         + rng.randn(n) * 0.1).astype(np.float32)
    return X, y


def _categorical_base(X, y):
    """A JAX model trained on the codes, with each split on feature 0 made
    categorical: threshold k - 0.5 becomes the right-set {k..9}."""
    base = jax_booster.train({"max_depth": 3, "max_bin": 32, "eta": 0.5},
                             JaxDataMatrix(X, labels=y), 3)
    for tree in base.trees:
        for node in np.nonzero((tree.left >= 0) & (tree.feature == 0))[0]:
            k = int(np.ceil(tree.threshold[node]))
            tree.categories[int(node)] = np.arange(max(k, 0), 10)
    assert any(t.has_categorical for t in base.trees)
    return base


@pytest.mark.parametrize("how", ["update", "resume"])
def test_training_from_a_categorical_model_matches_jax(how):
    X, y = _coded_rows()
    base = _categorical_base(X, y)
    doc = base.save_json()
    params = {"max_depth": 3, "max_bin": 32, "eta": 0.5}
    if how == "update":
        params.update(process_type="update", updater="refresh")
    y2 = y + 0.5
    ref = jax_booster.train(params, JaxDataMatrix(X, labels=y2), 3,
                            xgb_model=JaxForest.load_json(doc))
    ours = booster.train(params, DataMatrix(X, labels=y2), 3,
                         xgb_model=Forest.load_json(doc, device="cpu"), device="cpu",
                         verbose_eval=False)
    assert ours.iteration_indptr == ref.iteration_indptr
    for a, b in zip(ours.trees, ref.trees):
        np.testing.assert_array_equal(a.left, b.left)
        split = a.left >= 0
        np.testing.assert_array_equal(a.feature[split], b.feature[split])
        np.testing.assert_array_equal(a.threshold[split], b.threshold[split])
        assert sorted(a.categories) == sorted(b.categories)
        np.testing.assert_allclose(a.value, b.value, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=1e-5, atol=1e-5)
