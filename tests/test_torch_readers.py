"""The port's channel readers against the JAX package's: the same channel
directories give the same DataMatrix (features NaN-equal, labels, weights,
groups) or the same ``UserError`` in both packages.

The JAX csv reader parses with pandas, the port's with numpy; where an error
message comes from the parser itself, only its first line (the reader's
own words) is compared.
"""

import logging
import os
import sys

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data import readers as jax_readers
from sagemaker_xgboost_container_tpu.toolkit import exceptions as jax_exc
from sagemaker_xgboost_container_tpu_torch.data import readers
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc


@pytest.fixture(autouse=True)
def _private_jax_staging(tmp_path, monkeypatch):
    """The JAX reader stages every channel into one fixed directory; give it
    one of this test's own, so that parallel test workers do not share it."""
    stage = jax_readers.stage_input_files
    monkeypatch.setattr(jax_readers, "stage_input_files",
                        lambda path: stage(path, staging_dir=str(tmp_path / "jax_stage")))


def _rows(n, d, seed, missing=0.1):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, d), 4).astype(np.float32)
    X[rng.rand(n, d) < missing] = np.nan
    y = (rng.rand(n) < 0.4).astype(np.float32)
    w = np.round(rng.rand(n) + 0.5, 3).astype(np.float32)
    return X, y, w


def _fmt(v):
    return "" if np.isnan(v) else repr(float(v))


def _write_csv(path, X, y, w=None, delimiter=","):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for i in range(len(y)):
            head = [_fmt(y[i])] + ([_fmt(w[i])] if w is not None else [])
            f.write(delimiter.join(head + [_fmt(v) for v in X[i]]) + "\n")


def _write_libsvm(path, X, y, w=None, qid=None, sidecar_weights=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for i in range(len(y)):
            head = repr(float(y[i]))
            if w is not None and not sidecar_weights:
                head += ":{!r}".format(float(w[i]))
            toks = [head]
            if qid is not None:
                toks.append("qid:{}".format(qid[i]))
            toks += ["{}:{!r}".format(j, float(v)) for j, v in enumerate(X[i]) if not np.isnan(v)]
            f.write(" ".join(toks) + "\n")
    if sidecar_weights:
        np.savetxt(path + ".weight", w)


def _write_recordio(path, X, y):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        from sagemaker_xgboost_container_tpu.data import recordio as jax_recordio

        f.write(jax_recordio.write_recordio_protobuf(X, y))


def _build(case, root):
    """Write the channel of ``case`` under ``root`` -> (path, content type,
    csv_weights)."""
    ch = os.path.join(root, "channel")
    X, y, w = _rows(40, 5, seed=len(case))
    if case == "csv_comma":
        _write_csv(os.path.join(ch, "a.csv"), X[:25], y[:25])
        _write_csv(os.path.join(ch, "b.csv"), X[25:], y[25:])
        return ch, "text/csv", 0
    if case == "csv_tab":
        _write_csv(os.path.join(ch, "a.tsv"), X, y, delimiter="\t")
        return ch, "csv", 0
    if case == "csv_weights":
        _write_csv(os.path.join(ch, "a.csv"), X, y, w)
        return ch, "csv", 1
    if case == "csv_single_file_path":
        _write_csv(os.path.join(ch, "only.csv"), X, y)
        return os.path.join(ch, "only.csv"), "csv", 0
    if case == "csv_nested":
        _write_csv(os.path.join(ch, "a.csv"), X[:10], y[:10])
        _write_csv(os.path.join(ch, "sub", "b.csv"), X[10:20], y[10:20])
        _write_csv(os.path.join(ch, "sub", "deeper", "c.csv"), X[20:30], y[20:30])
        _write_csv(os.path.join(ch, "sub", "deeper", "deepest", "d.csv"), X[30:], y[30:])
        return ch, "csv", 0
    if case == "csv_empty_and_hidden_named":
        _write_csv(os.path.join(ch, "a.csv"), X, y)
        open(os.path.join(ch, "empty.csv"), "w").close()
        _write_csv(os.path.join(ch, "_SUCCESS"), X[:2], y[:2])
        return ch, "csv", 0
    if case == "csv_all_empty":
        os.makedirs(ch)
        open(os.path.join(ch, "empty.csv"), "w").close()
        return ch, "csv", 0
    if case == "csv_mixed_width_files":
        _write_csv(os.path.join(ch, "a.csv"), X[:20], y[:20])
        _write_csv(os.path.join(ch, "b.csv"), X[20:, :3], y[20:])
        return ch, "csv", 0
    if case == "csv_short_rows":
        _write_csv(os.path.join(ch, "a.csv"), X, y)
        with open(os.path.join(ch, "a.csv"), "a") as f:
            f.write("1.0,0.5,0.25\n")
        return ch, "csv", 0
    if case == "csv_long_row":
        _write_csv(os.path.join(ch, "a.csv"), X, y)
        with open(os.path.join(ch, "a.csv"), "a") as f:
            f.write(",".join(["1.0"] * 9) + "\n")
        return ch, "csv", 0
    if case == "csv_bad_label":
        _write_csv(os.path.join(ch, "a.csv"), X, y)
        with open(os.path.join(ch, "a.csv"), "a") as f:
            f.write("yes,1.0,2.0,3.0,4.0,5.0\n")
        return ch, "csv", 0
    if case == "csv_missing_label":
        _write_csv(os.path.join(ch, "a.csv"), X, y)
        with open(os.path.join(ch, "a.csv"), "a") as f:
            f.write(",1.0,2.0,3.0,4.0,5.0\n")
        return ch, "csv", 0
    if case == "csv_label_and_empty_column":
        os.makedirs(ch)
        with open(os.path.join(ch, "a.csv"), "w") as f:
            f.write("".join("{},\n".format(v) for v in y))
        return ch, "csv", 0
    if case == "csv_delimiter_mismatch":
        _write_csv(os.path.join(ch, "a.csv"), X[:20], y[:20])
        _write_csv(os.path.join(ch, "b.csv"), X[20:], y[20:], delimiter=";")
        return ch, "csv", 0
    if case == "csv_no_delimiter":
        os.makedirs(ch)
        with open(os.path.join(ch, "a.csv"), "w") as f:
            f.write("abc\n")
        return ch, "csv", 0
    if case == "csv_weights_missing_column":
        _write_csv(os.path.join(ch, "a.csv"), X[:, :0], y, w)
        return ch, "csv", 1
    if case == "libsvm_plain":
        _write_libsvm(os.path.join(ch, "a.libsvm"), X, y)
        return ch, "libsvm", 0
    if case == "libsvm_inline_weights":
        _write_libsvm(os.path.join(ch, "a.libsvm"), X, y, w)
        return ch, "text/libsvm", 0
    if case == "libsvm_qid":
        qid = np.repeat(np.arange(8), 5)
        _write_libsvm(os.path.join(ch, "a.libsvm"), X, y, qid=qid)
        return ch, "libsvm", 0
    if case == "libsvm_weight_sidecars":
        _write_libsvm(os.path.join(ch, "a.libsvm"), X[:20], y[:20], w[:20], sidecar_weights=True)
        _write_libsvm(os.path.join(ch, "b.libsvm"), X[20:], y[20:], w[20:], sidecar_weights=True)
        return ch, "libsvm", 0
    if case == "libsvm_group_sidecar":
        _write_libsvm(os.path.join(ch, "a.libsvm"), X, y)
        np.savetxt(os.path.join(ch, "a.libsvm.group"), [10, 10, 20], fmt="%d")
        return ch, "libsvm", 0
    if case == "libsvm_nested_and_empty":
        _write_libsvm(os.path.join(ch, "a.libsvm"), X[:20], y[:20])
        _write_libsvm(os.path.join(ch, "sub", "b.libsvm"), X[20:], y[20:])
        open(os.path.join(ch, "empty.libsvm"), "w").close()
        return ch, "libsvm", 0
    if case == "libsvm_bad_first_line":
        os.makedirs(ch)
        with open(os.path.join(ch, "a.libsvm"), "w") as f:
            f.write("1.0,2.0,3.0\n")
        return ch, "libsvm", 0
    if case == "recordio":
        _write_recordio(os.path.join(ch, "a.rec"), X[:30], y[:30])
        _write_recordio(os.path.join(ch, "b.rec"), X[30:], y[30:])
        return ch, "application/x-recordio-protobuf", 0
    if case == "recordio_no_labels":
        _write_recordio(os.path.join(ch, "a.rec"), X, None)
        return ch, "recordio-protobuf", 0
    if case == "missing_path":
        return os.path.join(root, "nope"), "csv", 0
    raise ValueError(case)


CASES = ["csv_comma", "csv_tab", "csv_weights", "csv_single_file_path", "csv_nested",
         "csv_empty_and_hidden_named", "csv_all_empty", "csv_mixed_width_files",
         "csv_short_rows", "csv_long_row", "csv_bad_label", "csv_missing_label",
         "csv_label_and_empty_column", "csv_delimiter_mismatch", "csv_no_delimiter",
         "csv_weights_missing_column", "libsvm_plain", "libsvm_inline_weights", "libsvm_qid",
         "libsvm_weight_sidecars", "libsvm_group_sidecar", "libsvm_nested_and_empty",
         "libsvm_bad_first_line", "recordio", "recordio_no_labels", "missing_path"]
PARSER_ERRORS = ("csv_long_row", "csv_bad_label")


def _load(mod, error_type, path, content_type, csv_weights):
    """validate_data_file_path + get_data_matrix, as the training job calls
    them -> ("ok", DataMatrix or None) or (error class name, message)."""
    try:
        if os.path.exists(path):
            mod.validate_data_file_path(path, content_type)
        return "ok", mod.get_data_matrix(path, content_type, csv_weights=csv_weights)
    except error_type as e:
        return type(e).__name__, str(e)


def _assert_same_matrix(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.features.shape == b.features.shape
    np.testing.assert_array_equal(a.features, b.features)  # NaN == NaN here
    np.testing.assert_array_equal(a.get_label(), b.get_label())
    for x, y in ((a.weights, b.weights), (a.groups, b.groups)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", CASES)
def test_channel_reads_match_jax(case, tmp_path):
    path, content_type, csv_weights = _build(case, str(tmp_path))
    a = _load(readers, exc.BaseToolkitError, path, content_type, csv_weights)
    b = _load(jax_readers, jax_exc.BaseToolkitError, path, content_type, csv_weights)
    assert a[0] == b[0], (a, b)
    if a[0] == "ok":
        _assert_same_matrix(a[1], b[1])
    elif case in PARSER_ERRORS:
        assert a[1].splitlines()[0] == b[1].splitlines()[0], (a, b)
    else:
        assert a[1] == b[1]
    expect_error = case in PARSER_ERRORS or case in (
        "csv_missing_label", "csv_delimiter_mismatch", "csv_no_delimiter",
        "csv_weights_missing_column", "libsvm_bad_first_line", "recordio_no_labels")
    assert (a[0] == "UserError") == expect_error, a
    if case in ("csv_all_empty", "missing_path"):
        assert a[1] is None


def _parquet_tables(kind, n=200, seed=3):
    """pyarrow tables (label first) of each column kind the parquet
    reader converts: nulls in float and int columns, ints, bools, f64 that
    rounds to f32."""
    import pyarrow as pa

    rng = np.random.RandomState(seed)
    label = pa.array((rng.rand(n) < 0.4).astype(np.float64))
    f64 = rng.randn(n) * 1e3 + 1e-7  # not representable in f32
    nulls = rng.rand(n) < 0.2
    if kind == "nulls":
        cols = {"f": pa.array(f64, mask=nulls),
                "i": pa.array(rng.randint(-5, 5, n).astype(np.int64), mask=~nulls & (
                    rng.rand(n) < 0.3)),
                "b": pa.array(rng.rand(n) < 0.5, mask=nulls)}
    elif kind == "ints":
        cols = {"i8": pa.array(rng.randint(-100, 100, n).astype(np.int8)),
                "i64": pa.array(rng.randint(-2**40, 2**40, n).astype(np.int64)),
                "u16": pa.array(rng.randint(0, 60000, n).astype(np.uint16))}
    elif kind == "bools":
        cols = {"b0": pa.array(rng.rand(n) < 0.5), "b1": pa.array(rng.rand(n) < 0.1)}
    else:  # f64, f32 and one column per file across two files
        cols = {"f64": pa.array(f64), "f32": pa.array(f64.astype(np.float32))}
    table = pa.table(dict({"label": label}, **cols))
    if kind == "two_files":
        return [table.slice(0, n // 2), table.slice(n // 2)]
    return [table]


@pytest.mark.parametrize("kind", ["nulls", "ints", "bools", "f64", "two_files"])
def test_parquet_names_the_gap(tmp_path, kind):
    """A parquet channel reads bit for bit as the JAX reader (pyarrow
    through pandas) reads it: nulls NaN, bools 0/1, ints and f64 rounded
    to f32, column 0 the label."""
    pq = pytest.importorskip("pyarrow.parquet")
    os.makedirs(str(tmp_path / "ch"))
    tables = _parquet_tables(kind)
    for i, table in enumerate(tables):
        pq.write_table(table, str(tmp_path / "ch" / "part-{}.parquet".format(i)))
    path = str(tmp_path / "ch")
    ours = readers.get_data_matrix(path, "application/x-parquet")
    ref = jax_readers.get_data_matrix(path, "application/x-parquet")
    assert ours.features.dtype == ref.features.dtype == np.float32
    assert ours.features.shape == ref.features.shape == (200, tables[0].num_columns - 1)
    np.testing.assert_array_equal(ours.features.view(np.uint32), ref.features.view(np.uint32))
    np.testing.assert_array_equal(ours.labels.view(np.uint32), ref.labels.view(np.uint32))
    if kind == "nulls":
        assert np.isnan(ours.features).any()


def test_parquet_without_pyarrow_names_it(tmp_path, monkeypatch):
    os.makedirs(str(tmp_path / "ch"))
    (tmp_path / "ch" / "a.parquet").write_bytes(b"PAR1")
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(exc.UserError, match="parquet channels need the pyarrow package"):
        readers.get_data_matrix(str(tmp_path / "ch"), "application/x-parquet")


def test_staging_is_private_and_removed(tmp_path):
    path, content_type, _ = _build("csv_nested", str(tmp_path))
    staged = readers.stage_input_files(path)
    assert sorted(os.listdir(staged)) and os.path.isdir(staged)
    readers.get_data_matrix(path, content_type)
    assert os.path.isdir(staged)  # a second read stages elsewhere
    assert readers.stage_input_files(os.path.join(str(tmp_path), "nope")) is None


@pytest.mark.parametrize("case", ["flat", "nested", "file", "missing", "hidden"])
def test_get_size_matches_jax(case, tmp_path):
    root = str(tmp_path / "ch")
    X, y, _ = _rows(10, 3, seed=1)
    path = root
    if case in ("flat", "nested", "hidden"):
        _write_csv(os.path.join(root, "a.csv"), X, y)
    if case == "nested":
        _write_csv(os.path.join(root, "sub", "b.csv"), X, y)
    if case == "hidden":
        _write_csv(os.path.join(root, "sub", ".hidden"), X, y)
    if case == "file":
        _write_csv(os.path.join(root, "a.csv"), X, y)
        path = os.path.join(root, "a.csv")

    def size(mod, error_type):
        try:
            return mod.get_size(path)
        except error_type as e:
            return str(e)

    a, b = size(readers, exc.UserError), size(jax_readers, jax_exc.UserError)
    assert a == b
    assert isinstance(a, str) == (case == "hidden")


@pytest.mark.parametrize("case", ["same_size", "different", "missing_train", "missing_val"])
def test_check_data_redundancy_matches_jax(case, tmp_path, caplog):
    train, val = str(tmp_path / "train"), str(tmp_path / "val")
    X, y, _ = _rows(10, 3, seed=2)
    if case != "missing_train":
        _write_csv(os.path.join(train, "data.csv"), X, y)
    if case != "missing_val":
        _write_csv(os.path.join(val, "data.csv"), X if case == "same_size" else X[:4],
                   y if case == "same_size" else y[:4])

    def run(mod, error_type):
        caplog.clear()
        try:
            with caplog.at_level(logging.WARNING):
                mod.check_data_redundancy(train, val)
            return "ok", [r.getMessage() for r in caplog.records if "identical" in r.getMessage()]
        except error_type as e:
            return "UserError", str(e)

    a, b = run(readers, exc.UserError), run(jax_readers, jax_exc.UserError)
    assert a == b
    assert a[0] == ("UserError" if case.startswith("missing") else "ok")
    assert bool(a[1]) == (case != "different")


def test_data_matrix_slice_and_concat_match_jax():
    from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix

    X, y, w = _rows(30, 5, seed=3)
    X2, y2, _ = _rows(12, 3, seed=4)
    ours = DataMatrix(X, y, w).concat(DataMatrix(X2, y2))
    ref = JaxDataMatrix(X, y, w).concat(JaxDataMatrix(X2, y2))
    _assert_same_matrix(ours, ref)
    rows = [0, 5, 31, 41, 7]
    _assert_same_matrix(ours.slice(rows), ref.slice(rows))
    with pytest.raises(exc.UserError, match="Group sizes sum to 29"):
        DataMatrix(X, y, groups=[10, 19])
