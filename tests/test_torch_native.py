"""The port's native data plane (``data/native.py`` over
``native/fastdata.cpp``) against the JAX package: the libsvm tokenizer
(native on one thread and on several, the Python fallback, the JAX
``parse_libsvm_text``: the same CSR, labels, weights and qids, and the same
line in an error), the small-payload forest traversal (native, the numpy
twin, JAX ``host_predict_margin`` within 1e-6, categorical splits and NaN
included; a corrupt model refused), the knobs ``GRAFT_PARSE_THREADS``,
``GRAFT_HOST_PREDICT_ROWS``, ``GRAFT_HOST_PREDICT_IMPL`` and
``GRAFT_PREDICT_WARMUP``, and the collective round fields a session leaves
behind. g++ builds the library here, as on the card."""

import json
import os
import re

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data import native as jax_native
from sagemaker_xgboost_container_tpu.data import readers as jax_readers
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import forest as jax_forest_mod
from sagemaker_xgboost_container_tpu.models import train as jax_train
from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest
from sagemaker_xgboost_container_tpu.models.forest import Tree as JaxTree
from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.data import native, readers, streaming
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import forest as forest_mod
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.ops import predict as predict_mod
from sagemaker_xgboost_container_tpu_torch.serving import serve_utils
from sagemaker_xgboost_container_tpu_torch.telemetry import emit
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.training import profiling
from tests.test_torch_categorical_cuda import cat_rows, random_cat_trees
from tests.util_torch_ranks import comm_fields_after_ranks, run_ranks

TOL = 1e-6
KNOBS = ("GRAFT_PARSE_THREADS", "GRAFT_HOST_PREDICT_ROWS", "GRAFT_HOST_PREDICT_IMPL",
         "GRAFT_PREDICT_WARMUP")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    native.reset_native_routes()
    forest_mod.reset_predict_counts()
    yield
    native.reset_native_routes()


def test_the_library_loads_from_the_ports_own_source_and_cache():
    """g++ is on this host: the library loads, built from
    ``native/fastdata.cpp`` into the port's cache (or shipped in the port's
    package), never the JAX package's."""
    assert native.native_available() and native.forest_predictor_available()
    info = native.load_info()
    assert info["route"] in ("built", "cached", "packaged")
    assert native._SOURCE.endswith("native/fastdata.cpp")
    if info["route"] == "packaged":
        assert info["path"].startswith(native._PKG_DIR)
    else:
        assert info["path"].startswith(native.cache_dir())
    assert "sm_xgb_tpu_native" not in info["path"]
    assert "sagemaker_xgboost_container_tpu/" not in info["path"]


# -------------------------------------------------------------- the parse

def libsvm_text(seed, rows=300, d=12, weights=True, qids=True):
    """Seeded libsvm text with ``label(:weight) (qid:q) idx:val ...`` rows,
    blank lines, whole-line comments, CRLF endings and trailing spaces."""
    rng = np.random.RandomState(seed)
    lines, qid = [], 0
    for i in range(rows):
        if rng.rand() < 0.2:
            qid += 1
        head = "{:.6g}".format(rng.randint(0, 3) + 0.5 * (rng.rand() < 0.3))
        if weights and rng.rand() < 0.7:
            head += ":{:.5g}".format(rng.rand() * 3)
        tokens = [head]
        if qids:
            tokens.append("qid:{}".format(qid))
        cols = np.sort(rng.choice(d, rng.randint(0, d), replace=False))
        tokens += ["{}:{:.7g}".format(c, np.float32(rng.randn() * 10 ** rng.randint(-3, 4)))
                   for c in cols]
        line = (" " if rng.rand() < 0.5 else "\t").join(tokens)
        if rng.rand() < 0.2:
            line += "  "
        lines.append(line + ("\r\n" if rng.rand() < 0.3 else "\n"))
        if rng.rand() < 0.05:
            lines.append("\n")
        if rng.rand() < 0.05:
            lines.append("# comment {}\n".format(i))
    return "".join(lines)


def _python_parse(monkeypatch, text, num_col=None):
    with monkeypatch.context() as m:
        m.setattr(native, "parse_libsvm_native", lambda data: None)
        return readers.parse_libsvm_text(text, num_col)


def _assert_same_parse(got, want):
    assert got[0].shape == want[0].shape
    for key in ("indptr", "indices", "data"):
        a, b = getattr(got[0], key), getattr(want[0], key)
        np.testing.assert_array_equal(a, b)
    assert got[0].data.dtype == want[0].data.dtype == np.float32
    for a, b in zip(got[1:], want[1:]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,weights,qids,num_col", [
    (0, True, True, None), (1, False, True, None), (2, True, False, None),
    (3, False, False, None), (4, True, True, 20)])
def test_parse_equals_python_and_jax(monkeypatch, seed, weights, qids, num_col):
    text = libsvm_text(seed, weights=weights, qids=qids)
    monkeypatch.setenv("GRAFT_PARSE_THREADS", "1")
    ours = readers.parse_libsvm_text(text, num_col)
    assert native.NATIVE_ROUTES["parse_native"] == 1
    python = _python_parse(monkeypatch, text, num_col)
    assert native.NATIVE_ROUTES["parse_python"] == 1
    jax = jax_readers.parse_libsvm_text(text, num_col)
    _assert_same_parse(ours, python)
    _assert_same_parse(ours, jax)
    assert (ours[2] is not None) == weights and (ours[3] is not None) == qids


@pytest.mark.parametrize("threads", [2, 3, 4, 7])
def test_threaded_parse_equals_one_thread(monkeypatch, threads):
    text = libsvm_text(10, rows=500)
    monkeypatch.setenv("GRAFT_PARSE_THREADS", "1")
    one = readers.parse_libsvm_text(text)
    monkeypatch.setattr(native, "_parse_threads", lambda nbytes: threads)
    _assert_same_parse(readers.parse_libsvm_text(text), one)


def test_parse_threads_knob_equals_jax(monkeypatch):
    """``GRAFT_PARSE_THREADS`` forces the count (1 or less: one thread);
    unset, one thread a ~8 MB slice, at most 16 and the host's cores. On a
    small text the forced count splits it and the parse is unchanged."""
    sizes = (0, 1 << 20, 9 << 20, 60 << 20, 1 << 30)
    for value in (None, "1", "4", "0", "-3", "32"):
        if value is None:
            monkeypatch.delenv("GRAFT_PARSE_THREADS", raising=False)
        else:
            monkeypatch.setenv("GRAFT_PARSE_THREADS", value)
        assert [native._parse_threads(n) for n in sizes] == \
            [jax_native._parse_threads(n) for n in sizes], value
    monkeypatch.setenv("GRAFT_PARSE_THREADS", "4")
    text = libsvm_text(11)
    threaded = readers.parse_libsvm_text(text)
    monkeypatch.setenv("GRAFT_PARSE_THREADS", "1")
    _assert_same_parse(threaded, readers.parse_libsvm_text(text))
    # a malformed value degrades to the default with a warning (the JAX
    # package raises its ValueError from the parse)
    monkeypatch.setenv("GRAFT_PARSE_THREADS", "many")
    assert native._parse_threads(60 << 20) == max(1, min(os.cpu_count() or 1, 16, 7))


def _line_of(err):
    return int(re.search(r"line (\d+)", str(err)).group(1))


BAD_LINES = ["1 2:abc", "1 x:1", "1 3", "abc 1:2", "1:x 0:1", "1 qid:x 0:1", "1 1:2:3"]


@pytest.mark.parametrize("bad", BAD_LINES)
def test_malformed_line_is_a_user_error_at_the_jax_line(monkeypatch, bad):
    good = libsvm_text(12, rows=40, weights=False)
    text = good + "\n# note\n" + bad + "\n" + good
    want = good.count("\n") + 3
    with pytest.raises(Exception) as jax_err:
        jax_readers.parse_libsvm_text(text)
    assert _line_of(jax_err.value) == want
    for threads in ("1", "4"):
        monkeypatch.setenv("GRAFT_PARSE_THREADS", threads)
        with pytest.raises(exc.UserError) as ours:
            readers.parse_libsvm_text(text)
        assert _line_of(ours.value) == want, threads
    with pytest.raises(exc.UserError) as python:
        _python_parse(monkeypatch, text)
    assert _line_of(python.value) == want


def test_streaming_chunks_parse_as_the_python_path(monkeypatch):
    """A libsvm byte range: the same chunk through either tokenizer, an
    empty chunk, and a chunk-local line number in an error."""
    raw = libsvm_text(13, rows=200).encode()
    ours = streaming._parse_libsvm_chunk(raw)
    with monkeypatch.context() as m:
        m.setattr(native, "parse_libsvm_native", lambda data: None)
        python = streaming._parse_libsvm_chunk(raw)
        empty_python = streaming._parse_libsvm_chunk(b"\n# only a comment\n")
    np.testing.assert_array_equal(ours.features, python.features)
    for key in ("labels", "weights", "qids"):
        np.testing.assert_array_equal(getattr(ours, key), getattr(python, key))
    empty = streaming._parse_libsvm_chunk(b"\n# only a comment\n")
    assert empty.features.shape == empty_python.features.shape == (0, 0)
    assert len(empty.labels) == len(empty_python.labels) == 0
    with pytest.raises(exc.UserError) as err:
        streaming._parse_libsvm_chunk(b"1 0:1\n0 1:2\n1 2:x\n")
    assert _line_of(err.value) == 3


# -------------------------------------------------------- the traversal

def _port(jax_forest):
    return Forest.load_json(jax_forest.save_json(), device="cpu")


def _trained(objective, num_class=None, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(600, 6).astype(np.float32)
    X[rng.rand(600, 6) < 0.1] = np.nan
    if num_class:
        y = rng.randint(0, num_class, 600).astype(np.float32)
    else:
        y = (np.nan_to_num(X[:, 0]) > 0.5).astype(np.float32)
    params = {"max_depth": 4, "objective": objective}
    if num_class:
        params["num_class"] = num_class
    return jax_train(params, JaxDataMatrix(X, labels=y), num_boost_round=6)


def _cat_forest(num_class=0):
    groups = max(1, num_class)
    trees = random_cat_trees(21, n_trees=8, groups=groups)
    forest = JaxForest(objective_name="multi:softprob" if num_class else "reg:squarederror",
                       base_score=0.5, num_feature=5, num_class=num_class)
    forest.trees = [JaxTree(**t) for t in trees]
    forest.tree_info = [i % groups for i in range(len(trees))]
    forest.iteration_indptr = list(range(0, len(trees) + 1, groups))
    return forest


def _rows(kind, n):
    if kind == "categorical":
        return cat_rows(22, n)
    rng = np.random.RandomState(7)
    X = rng.rand(n, 6).astype(np.float32)
    X[rng.rand(n, 6) < 0.2] = np.nan
    return X


CASES = {
    "binary": lambda: _trained("binary:logistic"),
    "softprob": lambda: _trained("multi:softprob", num_class=3),
    "categorical": lambda: _cat_forest(),
    "categorical softprob": lambda: _cat_forest(num_class=3),
}


@pytest.fixture(scope="module")
def forests():
    return {name: make() for name, make in CASES.items()}


@pytest.mark.parametrize("n", [1, 7, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_host_traversals_equal_jax(monkeypatch, forests, case, n):
    ref = forests[case]
    ours = _port(ref)
    X = _rows("categorical" if "categorical" in case else "numeric", n)
    monkeypatch.setenv("GRAFT_HOST_PREDICT_ROWS", "64")
    want = ref.predict_margin(X)
    got = ours.predict_margin(X)
    assert native.NATIVE_ROUTES["predict_native"] == 1
    monkeypatch.setenv("GRAFT_HOST_PREDICT_IMPL", "numpy")
    twin = ours.predict_margin(X)
    assert native.NATIVE_ROUTES["predict_numpy"] == 1
    assert forest_mod.PREDICTS == {"host": 2, "device": 0}
    assert got.shape == want.shape == twin.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(twin, want, rtol=TOL, atol=TOL)
    # the operands are cached on the host half of the stacked slice
    host, _dev = ours._stack()
    assert isinstance(host["_native_args"], tuple)


def _copy(host):
    return {k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v)
            for k, v in host.items() if k != "_native_args"}


def test_corrupt_model_refused_natively_and_raises_in_numpy(forests):
    """A node index out of range: the native traversal refuses the forest
    once (``"invalid"`` cached) and the numpy twin raises IndexError; a
    negative index or feature is refused too, and a split feature beyond
    the rows' width leaves the rows to the numpy twin."""
    host, _dev = _port(forests["binary"])._stack()
    N = host["left"].shape[1]
    x = _rows("numeric", 3)
    good = native.forest_leaf_values_native(_copy(host), x)
    assert good is not None and good.shape == (3, host["left"].shape[0])
    corrupt = _copy(host)
    corrupt["left"][:, 0] = N + 5
    corrupt["right"][:, 0] = N + 7
    assert native.forest_leaf_values_native(corrupt, x) is None
    assert corrupt["_native_args"] == "invalid"
    with pytest.raises(IndexError):
        predict_mod.host_predict_margin(corrupt, x)
    assert native.NATIVE_ROUTES["predict_numpy"] == 1
    for key, value in (("left", -2), ("right", -1), ("feature", -1)):
        corrupt = _copy(host)
        corrupt[key][0, 0] = value
        assert native.forest_leaf_values_native(corrupt, x) is None, key
        assert corrupt["_native_args"] == "invalid"
    fmax = int(host["feature"].max())
    assert native.forest_leaf_values_native(_copy(host), x[:, :fmax]) is None


@pytest.mark.parametrize("value,rows,path", [
    ("0", 1, "device"), ("64", 64, "host"), ("64", 65, "device"), (None, 32, "host"),
    (None, 33, "device"), ("off", 32, "host"), ("5", 6, "device")])
def test_host_predict_rows_knob(monkeypatch, forests, value, rows, path):
    """``GRAFT_HOST_PREDICT_ROWS``: the row count up to which a payload
    predicts on the host (0: none; malformed: the default 32), read as the
    JAX package reads it; the device path here is the CPU device."""
    if value is not None:
        monkeypatch.setenv("GRAFT_HOST_PREDICT_ROWS", value)
    assert forest_mod._host_predict_rows() == jax_forest_mod._host_predict_rows()
    ours = _port(forests["binary"])
    ours.predict(_rows("numeric", rows))
    assert forest_mod.PREDICTS == {"host": int(path == "host"), "device": int(path == "device")}


def test_host_predict_impl_knob(monkeypatch, forests):
    ours = _port(forests["softprob"])
    X = _rows("numeric", 4)
    a = ours.predict_margin(X)
    for value, route in (("numpy", "predict_numpy"), ("native", "predict_native"),
                         ("other", "predict_native")):
        monkeypatch.setenv("GRAFT_HOST_PREDICT_IMPL", value)
        native.reset_native_routes()
        np.testing.assert_allclose(ours.predict_margin(X), a, rtol=TOL, atol=TOL)
        assert native.NATIVE_ROUTES[route] == 1, value


@pytest.mark.parametrize("value,on", [
    (None, True), ("1", True), ("yes", True), ("typo", True), ("0", False),
    ("false", False), ("OFF", False), ("no", False)])
def test_predict_warmup_knob(monkeypatch, forests, value, on):
    """``GRAFT_PREDICT_WARMUP``: off for 0/false/off/no, else on. On, the
    warmup loads the native traversal and predicts ``_host_predict_rows() +
    1`` rows, the smallest device payload."""
    if value is not None:
        monkeypatch.setenv("GRAFT_PREDICT_WARMUP", value)
    monkeypatch.setenv("GRAFT_HOST_PREDICT_ROWS", "5")
    ours = _port(forests["binary"])
    seen = []
    predict = ours.predict
    monkeypatch.setattr(ours, "predict", lambda x, **kw: seen.append(x.shape) or predict(x, **kw))
    thread = serve_utils.warmup_predict_async(ours)
    if not on:
        assert thread is None and seen == []
        return
    thread.join(60)
    assert not thread.is_alive()
    assert seen == [(6, ours.num_feature)]
    assert forest_mod.PREDICTS == {"host": 0, "device": 1}
    assert native.forest_predictor_available()


# ------------------------------------------------ the collective fields

def _records(out, metric):
    needle = '"metric": "{}"'.format(metric)
    return [json.loads(line) for line in out.splitlines() if needle in line]


def test_one_rank_session_drops_stale_collective_fields(capsys):
    """A session clears the collective round fields at its start and end,
    as the JAX package's does: fields left by an earlier multi-rank run do
    not reach a one-rank run's records or its collective share."""
    emit.set_round_fields(hist_comm="psum", hist_comm_ms=12.5, hist_comm_bytes=4096)
    rng = np.random.RandomState(3)
    X = rng.randn(300, 4).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    train({"objective": "binary:logistic", "max_depth": 3}, DataMatrix(X, y), 3,
          device="cpu", callbacks=[profiling.RoundTimer(log_every=0)], verbose_eval=False)
    out = capsys.readouterr().out
    rounds = _records(out, "training.round")
    assert len(rounds) == 3
    assert not any(k.startswith("hist_comm") for r in rounds for k in r)
    assert _records(out, "training.attribution")[-1]["collective_ms"] == 0.0
    assert not any(k.startswith("hist_comm") for k in emit.get_round_fields())


def test_session_after_ranks_carries_no_collective_fields():
    """Two gloo ranks train together, then each alone in the same process:
    the first run's records carry its collectives, the second's none, and
    its collective share is 0."""
    for multi, alone, attribution in run_ranks(comm_fields_after_ranks, timeout=240):
        assert len(multi) == 3 and all("hist_comm_ms" in r for r in multi)
        assert len(alone) == 3
        assert not any(k.startswith("hist_comm") for r in alone for k in r)
        assert attribution["collective_ms"] == 0.0
