"""The port's streaming (chunked) channel ingest against the JAX package's,
on the CPU.

* chunk plans and their fingerprints, the summary sketch and
  ``cuts_from_summaries`` equal the JAX package's bit for bit;
* the chunked ``BinnedMatrix`` (bins, cuts, labels, weights, groups) equals
  the port's own whole-file ``bin_matrix`` and the JAX package's
  ``ingest_channel`` on the same files, for csv, libsvm, parquet and
  recordio-protobuf at several chunk sizes;
* training on it commits the whole-file path's trees, resumes from
  ``rep_block`` margins, and through the entry point writes a model
  byte-equal to the whole-file path's;
* ``_streaming_plan`` decides as the JAX package does over a grid of
  configs, modes and host counts;
* the fail / skip / budget ladder (``data.chunk`` faults and corrupt files)
  reaches the JAX package's verdicts and quarantine records, exits 85, and
  stamps the quarantine into the model's manifest;
* two loopback ranks agree on cuts and skip sets, refuse a plan
  divergence, and two hosts of the entry point write byte-equal models;
* the chunked path's memory stays bounded (a child process each).

Everything runs with ``device="cpu"``: ``device_apply`` bins the chunks
with torch ops there, as it does on the card.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data import binning as jax_binning
from sagemaker_xgboost_container_tpu.data import readers as jax_readers
from sagemaker_xgboost_container_tpu.data import streaming as jax_streaming
from sagemaker_xgboost_container_tpu.toolkit import exceptions as jax_exc
from sagemaker_xgboost_container_tpu.utils import faults as jax_faults
from sagemaker_xgboost_container_tpu_torch.data import binning, readers, streaming
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.data.recordio import write_recordio_protobuf
from sagemaker_xgboost_container_tpu_torch.models.booster import train
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, watchdog
from sagemaker_xgboost_container_tpu_torch.utils import faults
from tests.util_ports import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CT = {"csv": "text/csv", "libsvm": "text/libsvm", "parquet": "application/x-parquet",
      "recordio": "application/x-recordio-protobuf"}
TREE_FIELDS = ("feature", "threshold", "default_left", "left", "right")


@pytest.fixture(autouse=True)
def _clean_state():
    for mod in (streaming, jax_streaming):
        mod.reset_ingest_state()
    faults.reset()
    jax_faults.reset()
    yield
    for mod in (streaming, jax_streaming):
        mod.reset_ingest_state()
    faults.reset()
    jax_faults.reset()


def _jax(module):
    """A JAX-package module that imports sklearn at import time."""
    import importlib

    return importlib.import_module("sagemaker_xgboost_container_tpu." + module)


# ------------------------------------------------------------- channels
def _rows(n, d, seed, missing=0.08):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, n).astype(np.float32)
    X = rng.rand(n, d).astype(np.float32).round(4)
    X[:, 0] += labels  # a signal, so that trees grow
    X[rng.rand(n, d) < missing] = np.nan
    return labels, X


def _csv_channel(path, n_files=3, rows=250, d=6, seed=0, weights=False):
    """csv parts, missing values as empty fields; with ``weights`` an
    integer weight column after the label (csv_weights=1)."""
    os.makedirs(path, exist_ok=True)
    for i in range(n_files):
        labels, X = _rows(rows, d, seed + i)
        w = np.random.RandomState(seed + 50 + i).randint(1, 4, rows)
        with open(os.path.join(path, "part-{:02d}.csv".format(i)), "w") as f:
            for r in range(rows):
                head = ["%g" % labels[r]] + (["%d" % w[r]] if weights else [])
                f.write(",".join(head + ["" if np.isnan(v) else "%.6g" % v for v in X[r]])
                        + "\n")
    return n_files * rows


def _libsvm_channel(path, n_files=3, rows=200, d=6, seed=0, qid=False):
    os.makedirs(path, exist_ok=True)
    for i in range(n_files):
        labels, X = _rows(rows, d, seed + i)
        lines = []
        for r in range(rows):
            toks = ["%g" % labels[r]] + (["qid:%d" % (r // 10 + i * 1000)] if qid else [])
            toks += ["{}:{:.4f}".format(f, X[r, f]) for f in range(d) if not np.isnan(X[r, f])]
            lines.append(" ".join(toks))
        with open(os.path.join(path, "part-{:02d}.libsvm".format(i)), "w") as f:
            f.write("\n".join(lines) + "\n")
    return n_files * rows


def _parquet_channel(path, n_files=2, rows=300, d=5, seed=0):
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(path, exist_ok=True)
    for i in range(n_files):
        labels, X = _rows(rows, d, seed + i)
        cols = [pa.array(labels)] + [pa.array(X[:, f], mask=np.isnan(X[:, f]))
                                     for f in range(d)]
        table = pa.Table.from_arrays(cols, names=[str(c) for c in range(d + 1)])
        # small row groups, so that chunking has something to split
        pq.write_table(table, os.path.join(path, "part-{:02d}.parquet".format(i)),
                       row_group_size=64)
    return n_files * rows


def _recordio_channel(path, n_files=2, rows=300, d=5, seed=0):
    os.makedirs(path, exist_ok=True)
    for i in range(n_files):
        labels, X = _rows(rows, d, seed + i, missing=0.0)
        with open(os.path.join(path, "part-{:02d}.pbr".format(i)), "wb") as f:
            f.write(write_recordio_protobuf(X, labels=labels))
    return n_files * rows


MAKE = {"csv": _csv_channel, "libsvm": _libsvm_channel, "parquet": _parquet_channel,
        "recordio": _recordio_channel}


def _cfg(mod, chunk_bytes=4096, **overrides):
    cfg = mod.resolve_ingest_config()
    cfg.chunk_bytes = chunk_bytes
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def _ingest(path, fmt, chunk_bytes=4096, max_bin=256, cfg=None, **kw):
    """The port's ingest of ``path`` on the CPU."""
    return streaming.ingest_channel(path, CT[fmt], max_bin, config=cfg or _cfg(
        streaming, chunk_bytes), device="cpu", **kw)


def _jax_ingest(path, fmt, chunk_bytes=4096, max_bin=256, cfg=None, **kw):
    return jax_streaming.ingest_channel(path, CT[fmt], max_bin, config=cfg or _cfg(
        jax_streaming, chunk_bytes), **kw)


def _assert_same_matrix(a, b):
    assert a.bins.dtype == b.bins.dtype and a.bins.shape == b.bins.shape
    assert np.array_equal(a.bins, b.bins)
    assert np.array_equal(a.labels, b.labels)
    assert (a.weights is None) == (b.weights is None)
    if a.weights is not None:
        assert np.array_equal(a.weights, b.weights)
    assert (a.groups is None) == (b.groups is None)
    if a.groups is not None:
        assert np.array_equal(a.groups, b.groups)
    assert len(a.cut_points) == len(b.cut_points)
    for ca, cb in zip(a.cut_points, b.cut_points):
        assert ca.dtype == cb.dtype == np.float32 and np.array_equal(ca, cb)


def _assert_same_trees(a, b, leaf_tol=1e-6):
    assert len(a.trees) == len(b.trees) and a.trees
    for ta, tb in zip(a.trees, b.trees):
        for key in TREE_FIELDS:
            assert np.array_equal(getattr(ta, key), getattr(tb, key)), key
        np.testing.assert_allclose(ta.value, tb.value, rtol=0, atol=leaf_tol)


# ------------------------------------------------------------- knobs
@pytest.mark.parametrize("env", [
    {},
    {"SM_INGEST_MODE": "chunked", "SM_INGEST_BAD_CHUNK_ACTION": "skip"},
    {"SM_INGEST_MODE": "sideways", "SM_INGEST_BAD_CHUNK_ACTION": "ignore"},
    {"SM_INGEST_CHUNK_BYTES": "100", "SM_INGEST_MAX_BAD_CHUNKS": "-3"},
    {"SM_INGEST_SHARD": "1", "SM_INGEST_SKETCH_SIZE": "10", "SM_INGEST_WIRE_SKETCH": "9"},
    {"SM_INGEST_PORT": "70000", "SM_INGEST_TIMEOUT_S": "0.5"},
    {"SM_INGEST_CHUNK_BYTES": "16777216", "SM_INGEST_PORT": "9600"},
])
def test_ingest_config_matches_jax(monkeypatch, env):
    """Every SM_INGEST_* knob, its default and its clamp."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert vars(streaming.resolve_ingest_config()) == vars(jax_streaming.resolve_ingest_config())


# ------------------------------------------------------------- planning
@pytest.mark.parametrize("chunk_bytes", [4096, 9000, 1 << 20])
@pytest.mark.parametrize("fmt", sorted(CT))
def test_chunk_plan_matches_jax(tmp_path, fmt, chunk_bytes):
    channel = str(tmp_path / fmt)
    MAKE[fmt](channel)
    files = readers._list_data_files(channel)
    assert files == jax_readers._list_data_files(channel)
    ours = streaming.plan_channel(files, fmt_of(fmt), chunk_bytes)
    theirs = jax_streaming.plan_channel(files, fmt_of(fmt), chunk_bytes)
    assert [c.describe() for c in ours.chunks] == [c.describe() for c in theirs.chunks]
    assert ours.delimiter == theirs.delimiter
    assert ours.fingerprint() == theirs.fingerprint()
    if chunk_bytes == 4096:
        assert len(ours.chunks) > len(files)  # the files really split


def fmt_of(fmt):
    from sagemaker_xgboost_container_tpu_torch.data import content_types as ct

    return ct.get_content_type(CT[fmt])


# --------------------------------------------------------------- sketch
def _sketch_chunks(kind, seed=3):
    """Chunks of (features with NaN and duplicate values, row weights)."""
    rng = np.random.RandomState(seed)
    out = []
    for rows in (0, 57, 300, 1, 129):
        X = (rng.randint(0, 40, (rows, 4)) / 8.0).astype(np.float32)
        X[:, 3] = rng.rand(rows).astype(np.float32)          # mostly distinct
        X[rng.rand(rows, 4) < 0.1] = np.nan
        if rows:
            X[:, 2] = np.nan if rows == 1 else X[:, 2]       # an all-missing chunk column
        w = {"unit": None, "integer": rng.randint(1, 5, rows).astype(np.float32),
             "float": rng.rand(rows).astype(np.float32) + 0.1}[kind]
        out.append((X, w))
    return out


@pytest.mark.parametrize("cap", [1 << 17, 300])
@pytest.mark.parametrize("kind", ["unit", "integer", "float"])
def test_summary_sketch_and_cuts_match_jax(kind, cap):
    ours, theirs = streaming.SummarySketch(cap), jax_streaming.SummarySketch(cap)
    chunks = _sketch_chunks(kind)
    for X, w in chunks:
        ours.update(X, w)
        theirs.update(X, w)
    for (va, wa), (vb, wb) in zip(ours.summaries(4), theirs.summaries(4)):
        assert va.dtype == vb.dtype and np.array_equal(va, vb)
        assert wa.dtype == wb.dtype and np.array_equal(wa, wb)
        assert len(va) <= cap
    assert ours.encode(4, 64) == theirs.encode(4, 64)
    for (va, wa), (vb, wb) in zip(
            streaming.SummarySketch.decode_summaries(ours.encode(4, 64)),
            jax_streaming.SummarySketch.decode_summaries(theirs.encode(4, 64))):
        assert np.array_equal(va, vb) and np.array_equal(wa, wb)
    for max_bin in (16, 256):
        cuts = binning.cuts_from_summaries(ours.summaries(4), max_bin)
        jax_cuts = jax_binning.cuts_from_summaries(theirs.summaries(4), max_bin)
        for a, b in zip(cuts, jax_cuts):
            assert np.array_equal(a, b)
        if kind != "float" and cap > 1000:
            # exact under the cap: the whole-file sketch of the flat rows
            X = np.concatenate([x for x, _w in chunks])
            w = None if kind == "unit" else np.concatenate([w for _x, w in chunks])
            for a, b in zip(cuts, binning.compute_cut_points(X, w, max_bin)):
                assert np.array_equal(a, b)


def test_summary_compression_is_a_hard_cap():
    v = np.arange(1000, dtype=np.float32)
    w = np.random.RandomState(0).rand(1000)
    for cap in (2, 3, 64, 999, 1000):
        a = streaming._compress_summary(v, w, cap)
        b = jax_streaming._compress_summary(v, w, cap)
        assert len(a[0]) <= cap and np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[0][0] == 0 and a[0][-1] == 999
        assert np.isclose(a[1].sum(), w.sum())


def test_cuts_from_summaries_refuses_exact():
    with pytest.raises(exc.UserError):
        binning.cuts_from_summaries([], None)


# ------------------------------------------------------- bit identity
BIT_CASES = [("csv", 4096), ("csv", 32768), ("csv", 1 << 20), ("libsvm", 4096),
             ("libsvm", 32768), ("libsvm", 1 << 20), ("parquet", 4096), ("parquet", 1 << 20),
             ("recordio", 4096), ("recordio", 1 << 20)]


@pytest.mark.parametrize("fmt, chunk_bytes", BIT_CASES)
def test_chunked_matrix_bit_identity(tmp_path, fmt, chunk_bytes):
    """Chunked == the port's whole-file ``bin_matrix`` == the JAX package's
    chunked ingest: bins, cuts, labels (and weights, groups)."""
    channel = str(tmp_path / fmt)
    MAKE[fmt](channel)
    whole = binning.bin_matrix(readers.get_data_matrix(channel, CT[fmt]), 256)
    chunked = _ingest(channel, fmt, chunk_bytes)
    _assert_same_matrix(chunked, whole)
    _assert_same_matrix(chunked, _jax_ingest(channel, fmt, chunk_bytes))


@pytest.mark.parametrize("case", ["csv_weights", "libsvm_qid", "max_bin_16"])
def test_chunked_matrix_bit_identity_options(tmp_path, case):
    """Integer csv weights, libsvm query groups and a narrow max_bin."""
    channel = str(tmp_path / case)
    csv_weights, max_bin = 0, 256
    if case == "csv_weights":
        fmt, csv_weights = "csv", 1
        _csv_channel(channel, weights=True)
    elif case == "libsvm_qid":
        fmt = "libsvm"
        _libsvm_channel(channel, qid=True)
    else:
        fmt, max_bin = "csv", 16
        _csv_channel(channel)
    dm = readers.get_data_matrix(channel, CT[fmt], csv_weights=csv_weights)
    whole = binning.bin_matrix(dm, max_bin)
    chunked = _ingest(channel, fmt, max_bin=max_bin, csv_weights=csv_weights)
    _assert_same_matrix(chunked, whole)
    _assert_same_matrix(chunked, _jax_ingest(channel, fmt, max_bin=max_bin,
                                             csv_weights=csv_weights))
    if case != "max_bin_16":
        assert (chunked.weights if case == "csv_weights" else chunked.groups) is not None


def test_validation_channel_binned_with_train_cuts(tmp_path):
    """A validation channel bins with the training cuts in pass 1 and is read
    once, as in the JAX package."""
    tdir, vdir = str(tmp_path / "t"), str(tmp_path / "v")
    _csv_channel(tdir)
    _csv_channel(vdir, n_files=2, seed=7)
    tr = _ingest(tdir, "csv")
    reads = []
    real = streaming._load_chunk
    streaming._load_chunk = lambda *a: reads.append(a[1].index) or real(*a)
    try:
        va = _ingest(vdir, "csv", cut_points=tr.cut_points)
    finally:
        streaming._load_chunk = real
    assert len(reads) == len(set(reads))  # one read a chunk
    assert va.cut_points is tr.cut_points
    jva = _jax_ingest(vdir, "csv", cut_points=tr.cut_points)
    assert np.array_equal(va.bins, jva.bins) and np.array_equal(va.labels, jva.labels)
    whole = binning.bin_matrix(readers.get_data_matrix(vdir, "text/csv"), 256,
                               cut_points=tr.cut_points)
    assert np.array_equal(va.bins, whole.bins)


@pytest.mark.parametrize("case", ["wider_validation", "empty_channel", "semantic_error",
                                  "zero_rowgroup_part"])
def test_channel_edges_match_jax(tmp_path, case):
    """A validation channel wider than training and a csv_weights channel
    without a weight column raise UserError (not quarantined); an empty
    channel and an empty parquet part read as nothing, in both packages."""
    if case == "wider_validation":
        tdir, vdir = str(tmp_path / "t"), str(tmp_path / "v")
        _csv_channel(tdir, d=4)
        _csv_channel(vdir, n_files=1, d=7)
        for fn, mod in ((_ingest, exc), (_jax_ingest, jax_exc)):
            with pytest.raises(mod.UserError):
                fn(vdir, "csv", cut_points=fn(tdir, "csv").cut_points)
    elif case == "empty_channel":
        assert _ingest(str(tmp_path / "missing"), "csv") is None
        assert _jax_ingest(str(tmp_path / "missing"), "csv") is None
    elif case == "semantic_error":
        channel = str(tmp_path / "noweights")
        _csv_channel(channel, n_files=2, d=1)
        for fn, mod, smod in ((_ingest, exc, streaming), (_jax_ingest, jax_exc, jax_streaming)):
            with pytest.raises(mod.UserError) as err:
                fn(channel, "csv", csv_weights=1, cfg=_cfg(smod, action="skip", max_bad=100))
            assert "csv_weights" in str(err.value)
            assert smod.quarantine_record() is None
    else:
        import pyarrow as pa
        import pyarrow.parquet as pq

        channel = str(tmp_path / "pq")
        expected = _parquet_channel(channel, n_files=1)
        schema = pa.schema([(str(i), pa.float32()) for i in range(6)])
        pq.ParquetWriter(os.path.join(channel, "part-00-empty.parquet"), schema).close()
        assert _ingest(channel, "parquet").num_row == expected
        assert streaming.quarantine_record() is None


# ------------------------------------------------------ training on it
PARAMS = {
    "binary": {"objective": "binary:logistic", "max_depth": 3, "max_bin": 256},
    "squarederror": {"objective": "reg:squarederror", "max_depth": 4, "max_bin": 256,
                     "eta": 0.5},
    "softprob": {"objective": "multi:softprob", "num_class": 2, "max_depth": 3,
                 "max_bin": 256},
}


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_committed_trees_match_whole_file(tmp_path, name, fmt):
    channel = str(tmp_path / fmt)
    MAKE[fmt](channel)
    dm = readers.get_data_matrix(channel, CT[fmt])
    bm = _ingest(channel, fmt, 8192)
    ref = train(dict(PARAMS[name]), dm, 4, evals=[(dm, "train")], device="cpu",
                verbose_eval=False)
    got = train(dict(PARAMS[name]), bm, 4, evals=[(bm, "train")], device="cpu",
                verbose_eval=False)
    _assert_same_trees(got, ref)
    a = np.asarray(ref.predict(dm.features), np.float32)
    b = np.asarray(got.predict(dm.features), np.float32)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_warm_start_from_binned(tmp_path, name):
    """Resuming on a pre-binned matrix starts from ``rep_block`` margins:
    the resumed trees are the float path's."""
    channel = str(tmp_path / "csv")
    _csv_channel(channel)
    dm = readers.get_data_matrix(channel, "text/csv")
    bm = _ingest(channel, "csv")
    p = PARAMS[name]
    a = train(dict(p), dm, 2, device="cpu", verbose_eval=False)
    a2 = train(dict(p), dm, 2, xgb_model=a, device="cpu", verbose_eval=False)
    b = train(dict(p), bm, 2, device="cpu", verbose_eval=False)
    b2 = train(dict(p), bm, 2, xgb_model=b, device="cpu", verbose_eval=False)
    _assert_same_trees(b2, a2, leaf_tol=0.0)


def test_warm_start_margins_over_blocks(tmp_path, monkeypatch):
    """Margins rebuilt from more than one ``rep_block`` block equal the
    float features' margins bit for bit."""
    from sagemaker_xgboost_container_tpu_torch.models import booster

    monkeypatch.setattr(booster, "_REP_BLOCK_ROWS", 97)
    channel = str(tmp_path / "csv")
    _csv_channel(channel)
    dm = readers.get_data_matrix(channel, "text/csv")
    bm = _ingest(channel, "csv")
    p = PARAMS["binary"]
    base = train(dict(p), dm, 3, device="cpu", verbose_eval=False)
    a = train(dict(p), dm, 1, xgb_model=base, device="cpu", verbose_eval=False)
    b = train(dict(p), bm, 1, xgb_model=base, device="cpu", verbose_eval=False)
    _assert_same_trees(b, a, leaf_tol=0.0)


def test_rep_block_routes_identically(tmp_path):
    channel = str(tmp_path / "csv")
    _csv_channel(channel, n_files=1, rows=200)
    bm = _ingest(channel, "csv")
    reps = bm.rep_block(0, bm.num_row)
    assert np.array_equal(binning.apply_cut_points(reps, bm.cut_points, bm.max_bin), bm.bins)
    assert np.array_equal(reps, jax_binning.BinnedMatrix(
        bm.bins, bm.cut_points, bm.max_bin).rep_block(0, bm.num_row), equal_nan=True)
    with pytest.raises(exc.AlgorithmError):
        bm.features  # no silent float rehydration


@pytest.mark.parametrize("cuts", [
    [0.25, 0.5], [-3.0, 1e-30, 2.0], [1.0], [np.float32(1e-45)], [-np.float32(1e30)]])
def test_rep_block_bin0_strictly_below_first_cut(cuts):
    cuts = np.asarray(cuts, np.float32)
    bins = np.arange(len(cuts) + 1, dtype=np.uint8)[:, None]
    bm = binning.BinnedMatrix(bins, [cuts], len(cuts) + 1, labels=np.zeros(len(bins)))
    rep = bm.rep_block(0, len(bins))[:, 0]
    assert rep.dtype == np.float32
    assert rep[0] < cuts[0]
    assert np.array_equal(rep[1:], cuts)
    assert np.array_equal(binning.apply_cut_points(rep[:, None], [cuts], bm.max_bin), bins)


@pytest.mark.parametrize("case", ["max_bin_drift", "eval_other_cuts", "gblinear", "dart",
                                  "update", "approx"])
def test_pre_binned_guards(tmp_path, case):
    """The session's guards on pre-binned input, the JAX package's."""
    channel = str(tmp_path / "csv")
    _csv_channel(channel)
    bm = _ingest(channel, "csv")
    p = dict(PARAMS["binary"])
    if case == "max_bin_drift":
        with pytest.raises(exc.UserError, match="max_bin"):
            train(dict(p, max_bin=64), bm, 1, device="cpu")
    elif case == "eval_other_cuts":
        other = _ingest(channel, "csv", max_bin=256, cut_points=[c[:-1] for c in bm.cut_points])
        with pytest.raises(exc.AlgorithmError, match="different cut points"):
            train(p, bm, 1, evals=[(other, "validation")], device="cpu")
    elif case == "approx":
        # keeps the ingest-time sketch: hist's trees on the same bins
        got = train(dict(p, tree_method="approx"), bm, 2, device="cpu", verbose_eval=False)
        _assert_same_trees(got, train(dict(p, tree_method="hist"), bm, 2, device="cpu",
                                      verbose_eval=False), leaf_tol=0.0)
    else:
        extra = {"gblinear": {"booster": "gblinear"}, "dart": {"booster": "dart"},
                 "update": {"process_type": "update", "updater": "refresh"}}[case]
        with pytest.raises(exc.UserError, match="Pre-binned"):
            train(dict(p, **extra), bm, 1, device="cpu")


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
def test_drift_baseline_from_pre_binned(tmp_path, fmt):
    """The drift baseline a session captures from a pre-binned matrix is
    the whole-file path's and the JAX package's."""
    from sagemaker_xgboost_container_tpu.telemetry import model as jax_model_telemetry
    from sagemaker_xgboost_container_tpu_torch.telemetry import model as model_telemetry

    channel = str(tmp_path / fmt)
    MAKE[fmt](channel)
    bm = _ingest(channel, fmt)
    whole = binning.bin_matrix(readers.get_data_matrix(channel, CT[fmt]), 256)
    ours = model_telemetry.baseline_from_binned(bm)
    assert ours == model_telemetry.baseline_from_binned(whole)
    assert ours == jax_model_telemetry.baseline_from_binned(_jax_ingest(channel, fmt))


# ---------------------------------------------------------- the plan
PLAN_CFGS = {
    "none": None,
    "binary": {"objective": "binary:logistic"},
    "max_bin_64": {"objective": "binary:logistic", "max_bin": 64},
    "sketch_eps": {"objective": "binary:logistic", "sketch_eps": 0.1},
    "gblinear": {"booster": "gblinear"},
    "dart": {"booster": "dart"},
    "exact": {"tree_method": "exact"},
    "approx": {"tree_method": "approx"},
    "update": {"process_type": "update"},
}


@pytest.mark.parametrize("mode", ["auto", "whole", "chunked"])
@pytest.mark.parametrize("cfg_name", sorted(PLAN_CFGS))
def test_streaming_plan_matches_jax(monkeypatch, cfg_name, mode):
    """Over sizes, host counts, k-fold and pipe: the same decision, max_bin
    and refusal text as the JAX package's ``_streaming_plan``."""
    jax_at = _jax("training.algorithm_train")
    monkeypatch.setenv("SM_INGEST_MODE", mode)
    monkeypatch.setenv("SM_INGEST_CHUNK_BYTES", "65536")
    for size in (0, 65536, 65537):
        for kfold in (False, True):
            for pipe in (False, True):
                for hosts in (1, 2):
                    args = (PLAN_CFGS[cfg_name], size, kfold, pipe, hosts)
                    try:
                        want = jax_at._streaming_plan(*args)[:2]
                    except jax_exc.UserError as e:
                        with pytest.raises(exc.UserError) as err:
                            algorithm_train._streaming_plan(*args)
                        assert str(err.value) == str(e), args
                        continue
                    assert algorithm_train._streaming_plan(*args)[:2] == want, args


@pytest.mark.parametrize("mode", ["auto", "chunked"])
def test_libsvm_sidecars_pin_whole_path(tmp_path, monkeypatch, mode):
    channel = str(tmp_path / "libsvm")
    _libsvm_channel(channel, n_files=1, rows=400)
    with open(os.path.join(channel, "part-00.libsvm.weight"), "w") as f:
        f.write("\n".join(["1.5"] * 400) + "\n")
    assert streaming.channel_has_sidecars("text/libsvm", channel)
    assert not streaming.channel_has_sidecars("text/csv", channel)
    assert not streaming.channel_has_sidecars("text/libsvm", None)
    monkeypatch.setenv("SM_INGEST_CHUNK_BYTES", "4096")
    monkeypatch.setenv("SM_INGEST_MODE", mode)
    args = (channel, None, "text/libsvm")
    kw = dict(train_cfg={"objective": "binary:logistic"}, device="cpu")
    if mode == "chunked":
        with pytest.raises(exc.UserError, match="sidecar"):
            algorithm_train.get_validated_data_matrices(*args, **kw)
    else:
        tr, _, _ = algorithm_train.get_validated_data_matrices(*args, **kw)
        assert isinstance(tr, DataMatrix) and np.all(tr.weights == np.float32(1.5))


def test_auto_mode_streams_large_single_host(tmp_path, monkeypatch):
    monkeypatch.setenv("SM_INGEST_CHUNK_BYTES", "4096")
    tdir, vdir = str(tmp_path / "t"), str(tmp_path / "v")
    _csv_channel(tdir)
    _csv_channel(vdir, n_files=1, seed=4)
    cfg = {"objective": "binary:logistic"}
    tr, va, tv = algorithm_train.get_validated_data_matrices(
        tdir, vdir, "text/csv", train_cfg=cfg, device="cpu")
    assert isinstance(tr, binning.BinnedMatrix) and tv is tr
    assert isinstance(va, binning.BinnedMatrix) and va.cut_points is tr.cut_points
    monkeypatch.setenv("SM_INGEST_MODE", "whole")
    tr2, _, _ = algorithm_train.get_validated_data_matrices(tdir, None, "text/csv",
                                                            train_cfg=cfg, device="cpu")
    assert isinstance(tr2, DataMatrix)


# ------------------------------------------------------ the entry point
HP = {"num_round": "5", "max_depth": "4", "max_bin": "64", "eta": "0.3",
      "objective": "binary:logistic", "eval_metric": "logloss,auc"}
CHANNEL = {"ContentType": "text/csv", "TrainingInputMode": "File",
           "S3DistributionType": "FullyReplicated"}


def _sagemaker_train(tmp_path, name, tdir, vdir, hp=HP):
    model_dir = str(tmp_path / name)
    algorithm_train.sagemaker_train(
        dict(hp), {"train": CHANNEL, "validation": dict(CHANNEL)}, tdir, vdir, model_dir,
        ["algo-1"], "algo-1", {}, device="cpu")
    return model_dir


@pytest.mark.parametrize("chunk_bytes", ["4096", "16384"])
def test_entry_auto_streams_byte_equal_model(tmp_path, monkeypatch, chunk_bytes):
    """``auto`` streams a channel larger than one chunk, and the model file
    equals the whole-file path's byte for byte."""
    tdir, vdir = str(tmp_path / "t"), str(tmp_path / "v")
    _csv_channel(tdir, n_files=2, rows=600)
    _csv_channel(vdir, n_files=1, rows=300, seed=9)
    calls = []
    real = streaming.ingest_channel
    monkeypatch.setattr(streaming, "ingest_channel",
                        lambda *a, **k: calls.append(k["channel"]) or real(*a, **k))
    monkeypatch.setenv("SM_INGEST_MODE", "whole")
    whole = _sagemaker_train(tmp_path, "whole", tdir, vdir)
    assert calls == []
    monkeypatch.setenv("SM_INGEST_MODE", "auto")
    monkeypatch.setenv("SM_INGEST_CHUNK_BYTES", chunk_bytes)
    auto = _sagemaker_train(tmp_path, "auto", tdir, vdir)
    assert calls == ["train", "validation"]
    with open(os.path.join(whole, "xgboost-model"), "rb") as a, \
            open(os.path.join(auto, "xgboost-model"), "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(os.path.join(auto, "ingest-quarantine.json"))


# ------------------------------------------------ the bad-chunk ladder
def _configure(spec):
    faults.configure(spec)
    jax_faults.configure(spec)


LADDER = {
    # name: (fault spec, action, max_bad, want: "ok" | reason)
    "skip_one": ("data.chunk:error:injected corruption@2", "skip", 8, "ok"),
    "fail": ("data.chunk:error:boom@2", "fail", 8, "bad_chunk"),
    "budget": ("data.chunk:error:rot@2+", "skip", 1, "budget_exceeded"),
    "skip_two": ("data.chunk:error:rot@3;data.chunk:error:rot@5", "skip", 2, "ok"),
    "retry_blip": ("data.chunk:error:blip@2", "fail", 8, "ok"),
}


@pytest.mark.parametrize("name", sorted(LADDER))
def test_fault_ladder_matches_jax(tmp_path, monkeypatch, name):
    """``data.chunk`` faults: the same verdict, rows and quarantine record,
    field for field, as the JAX package."""
    spec, action, max_bad, want = LADDER[name]
    monkeypatch.setenv("SM_IO_RETRY_ATTEMPTS", "3" if name == "retry_blip" else "1")
    monkeypatch.setenv("SM_IO_RETRY_BACKOFF_S", "0")
    monkeypatch.setenv("SM_INGEST_BAD_CHUNK_ACTION", action)
    monkeypatch.setenv("SM_INGEST_MAX_BAD_CHUNKS", str(max_bad))
    channel = str(tmp_path / "csv")
    total = _csv_channel(channel)
    results = []
    for fn, smod in ((_ingest, streaming), (_jax_ingest, jax_streaming)):
        _configure(spec)
        cfg = _cfg(smod, 4096, action=action, max_bad=max_bad)
        if want == "ok":
            results.append((fn(channel, "csv", cfg=cfg), smod.quarantine_record()))
        else:
            with pytest.raises(smod.IngestError) as err:
                fn(channel, "csv", cfg=cfg)
            assert err.value.reason == want
            results.append((None, smod.quarantine_record()))
    (ours, record), (theirs, jax_record) = results
    assert record == jax_record
    if want == "ok":
        _assert_same_matrix(ours, theirs)
        skipped = record["rows_skipped"] if record else 0
        assert ours.num_row == total - skipped
        if name.startswith("skip"):
            assert record["chunks_skipped"] == int(name[-3:] == "two") + 1
            assert all("rot" in c["error"] or "injected" in c["error"]
                       for c in record["skipped_chunks"])
    else:
        assert record is None


def _corrupt_channel(tmp_path, fmt):
    """Good parts plus one corrupt file (sorted last)."""
    channel = str(tmp_path / ("corrupt-" + fmt))
    good = MAKE[fmt](channel, n_files=2)
    bad = os.path.join(channel, "zz-corrupt")
    if fmt == "csv":
        with open(bad + ".csv", "w") as f:
            f.write("1.0,junk,2.0\n0.0\n1.0,2.0,3.0,4.0,5.0,6.0,7.0,8.0,9.0\n")
    elif fmt == "libsvm":
        with open(bad + ".libsvm", "w") as f:
            f.write("1 0:0.5 not:a:valid:token 3:0.2\n")
    elif fmt == "parquet":
        with open(bad + ".parquet", "wb") as f:
            f.write(b"\x89PNG not parquet at all" * 40)
    else:
        with open(bad + ".pbr", "wb") as f:
            f.write(b"\xde\xad\xbe\xef" * 64)
    return channel, good


@pytest.mark.parametrize("action", ["skip", "fail"])
@pytest.mark.parametrize("fmt", sorted(CT))
def test_corrupt_file_matches_jax(tmp_path, monkeypatch, fmt, action):
    """A corrupt file: whole-file UserError; chunked ``fail`` raises
    bad_chunk, ``skip`` quarantines exactly the corrupt file's chunks. The
    records equal the JAX package's in every field but ``error`` (each
    package's parser words its own exception)."""
    monkeypatch.setenv("SM_INGEST_BAD_CHUNK_ACTION", action)
    monkeypatch.setenv("SM_INGEST_MAX_BAD_CHUNKS", "16")
    channel, good = _corrupt_channel(tmp_path, fmt)
    with pytest.raises(exc.UserError):
        readers.get_data_matrix(channel, CT[fmt])
    if action == "fail":
        for fn, smod in ((_ingest, streaming), (_jax_ingest, jax_streaming)):
            with pytest.raises(smod.IngestError) as err:
                fn(channel, fmt, cfg=_cfg(smod, action="fail"))
            assert err.value.reason == "bad_chunk"
            assert smod.quarantine_record() is None
        return
    ours = _ingest(channel, fmt, cfg=_cfg(streaming, action="skip", max_bad=16))
    theirs = _jax_ingest(channel, fmt, cfg=_cfg(jax_streaming, action="skip", max_bad=16))
    assert ours.num_row == theirs.num_row == good
    _assert_same_matrix(ours, theirs)
    record, jax_record = streaming.quarantine_record(), jax_streaming.quarantine_record()
    assert record["chunks_skipped"] >= 1 and record["bytes_skipped"] > 0

    def strip(rec):
        return dict(rec, skipped_chunks=[{k: v for k, v in c.items() if k != "error"}
                                         for c in rec["skipped_chunks"]])

    assert strip(record) == strip(jax_record)
    assert all("zz-corrupt" in os.path.basename(c["file"]) for c in record["skipped_chunks"])


@pytest.mark.parametrize("case", ["plan_io", "staging_io", "fresh_state"])
def test_ingest_state_and_plan_failures(tmp_path, monkeypatch, case):
    """A planning or staging IO failure is an IngestError (exit 85 plane);
    a second job's ingest starts with an empty record and a full budget."""
    channel = str(tmp_path / "csv")
    _csv_channel(channel, n_files=1)
    monkeypatch.setenv("SM_IO_RETRY_ATTEMPTS", "1")
    monkeypatch.setenv("SM_IO_RETRY_BACKOFF_S", "0")
    if case == "plan_io":
        real_getsize = os.path.getsize

        def getsize(path):
            if str(path).endswith(".csv"):
                raise OSError("channel blip")
            return real_getsize(path)

        monkeypatch.setattr(os.path, "getsize", getsize)
        with pytest.raises(streaming.IngestError) as err:
            _ingest(channel, "csv")
        assert err.value.reason == "plan_failed"
    elif case == "staging_io":
        monkeypatch.setattr(readers, "stage_input_files",
                            lambda path: (_ for _ in ()).throw(OSError("listing blip")))
        with pytest.raises(streaming.IngestError) as err:
            _ingest(channel, "csv")
        assert err.value.reason == "plan_failed"
    else:
        _configure("data.chunk:error:rot@2")
        cfg = _cfg(streaming, action="skip", max_bad=1)
        _ingest(channel, "csv", cfg=cfg)
        assert streaming.quarantine_record()["chunks_skipped"] == 1
        streaming.reset_ingest_state()
        assert streaming.quarantine_record() is None
        _configure("data.chunk:error:rot@2")
        _ingest(channel, "csv", cfg=cfg)  # the budget of 1 is whole again
        assert streaming.quarantine_record()["chunks_skipped"] == 1


class _Exited(BaseException):
    pass


@pytest.mark.parametrize("name", ["fail", "budget"])
def test_ingest_error_exits_85(tmp_path, monkeypatch, name):
    """sagemaker_train turns an IngestError into the watchdog's abort with
    EXIT_INGEST_FAILED (the exit faked)."""
    spec, action, max_bad, reason = LADDER[name]
    monkeypatch.setenv("SM_IO_RETRY_ATTEMPTS", "1")
    monkeypatch.setenv("SM_INGEST_MODE", "chunked")
    monkeypatch.setenv("SM_INGEST_CHUNK_BYTES", "4096")
    monkeypatch.setenv("SM_INGEST_BAD_CHUNK_ACTION", action)
    monkeypatch.setenv("SM_INGEST_MAX_BAD_CHUNKS", str(max_bad))
    tdir = str(tmp_path / "t")
    _csv_channel(tdir)
    codes = []

    def fake_exit(code):
        codes.append(code)
        raise _Exited()

    monkeypatch.setattr(watchdog, "_exit", fake_exit)
    watchdog._reset_abort_for_tests()
    faults.configure(spec)
    try:
        with pytest.raises(_Exited):
            algorithm_train.sagemaker_train(
                dict(HP), {"train": CHANNEL}, tdir, None, str(tmp_path / "model"),
                ["algo-1"], "algo-1", {}, device="cpu")
    finally:
        watchdog._reset_abort_for_tests()
    assert codes == [85]
    assert not os.path.exists(os.path.join(str(tmp_path / "model"), "xgboost-model"))


def test_abort_on_ingest_failure_exits_85(monkeypatch):
    calls = []
    monkeypatch.setattr(watchdog, "_exit", lambda code: calls.append(code))
    watchdog._reset_abort_for_tests()
    try:
        streaming.abort_on_ingest_failure(streaming.IngestError("budget_exceeded", "drill"))
    finally:
        watchdog._reset_abort_for_tests()
    assert calls == [85]


def test_quarantine_stamped_into_model_manifest(tmp_path, monkeypatch):
    """``train_job`` writes the agreed quarantine into the model's manifest
    and ``ingest-quarantine.json``, equal to the JAX package's record of the
    same ingest."""
    monkeypatch.setenv("SM_IO_RETRY_ATTEMPTS", "1")
    monkeypatch.setenv("SM_INGEST_BAD_CHUNK_ACTION", "skip")
    channel = str(tmp_path / "csv")
    _csv_channel(channel)
    _configure("data.chunk:error:rot@2")
    bm = _ingest(channel, "csv", cfg=_cfg(streaming, action="skip", max_bad=8))
    _jax_ingest(channel, "csv", cfg=_cfg(jax_streaming, action="skip", max_bad=8))
    faults.reset()
    model_dir = str(tmp_path / "model")
    algorithm_train.train_job(
        {"objective": "binary:logistic", "max_depth": 2, "max_bin": 256, "num_round": 2},
        bm, None, bm, model_dir, None, is_master=True, device="cpu")
    with open(os.path.join(model_dir, "xgboost-model.manifest")) as f:
        manifest = json.load(f)
    with open(os.path.join(model_dir, "ingest-quarantine.json")) as f:
        qdoc = json.load(f)
    assert manifest["quarantine"]["chunks_skipped"] == 1
    assert qdoc == manifest["quarantine"] == jax_streaming.quarantine_record()


# ---------------------------------------------------- across ranks
HOSTS = ["algo-1", "algo-2"]


def _two_ranks(ingest, channels, **cfg_kw):
    """``ingest(channel, hosts=, current_host=, master_addr=, cfg=)`` on two
    loopback ranks (threads) over a free port of the call's own ->
    ({rank: result}, {rank: error})."""
    port = free_port()
    results, errors = {}, {}

    def run(rank):
        smod = streaming if ingest is _ingest else jax_streaming
        cfg = _cfg(smod, 8192, port=port, timeout_s=30.0, **cfg_kw)
        try:
            results[rank] = ingest(channels[rank], "csv", cfg=cfg, hosts=HOSTS,
                                   current_host=HOSTS[rank], master_addr="127.0.0.1")
        except Exception as e:
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return results, errors


@pytest.mark.parametrize("shard", [True, False])
def test_two_ranks_agree_on_cuts_and_skip_set(tmp_path, shard):
    """Two loopback ranks, one corrupt chunk: the same cuts on both, the same
    quarantine, and the JAX package's cuts and rows. Sharded, both read one
    replicated channel round-robin; unsharded, each its own channel
    (``ShardedByS3Key``), split unevenly."""
    if shard:
        shared = str(tmp_path / "shared")
        _csv_channel(shared, n_files=4, rows=300)
        with open(os.path.join(shared, "zz-rot.csv"), "w") as f:
            f.write("1.0,garbage,here\nnope\n")
        channels = [shared, shared]
    else:
        channels = [str(tmp_path / "a"), str(tmp_path / "b")]
        _csv_channel(channels[0], n_files=3, rows=300, seed=1)
        _csv_channel(channels[1], n_files=1, rows=200, seed=8)
        with open(os.path.join(channels[1], "zz-rot.csv"), "w") as f:
            f.write("1.0,garbage,here\nnope\n")
    kw = dict(action="skip", max_bad=8, shard=shard)
    ours, errs = _two_ranks(_ingest, channels, **kw)
    assert not errs, errs
    record = streaming.quarantine_record()
    theirs, jax_errs = _two_ranks(_jax_ingest, channels, **kw)
    assert not jax_errs, jax_errs
    for ca, cb, cj in zip(ours[0].cut_points, ours[1].cut_points, theirs[0].cut_points):
        assert np.array_equal(ca, cb) and np.array_equal(ca, cj)
    for r in (0, 1):
        _assert_same_matrix(ours[r], theirs[r])
    assert record["chunks_skipped"] >= 1
    assert all("zz-rot" in os.path.basename(c["file"]) for c in record["skipped_chunks"])
    jax_record = jax_streaming.quarantine_record()
    # both ranks of a package record the agreed union once each
    assert record["chunks_skipped"] == jax_record["chunks_skipped"]
    assert ours[0].num_row + ours[1].num_row == (1200 if shard else 1100)


def test_two_ranks_plan_divergence(tmp_path):
    """Ranks sharding channels of different bytes both raise
    plan_divergence, as the JAX package's do."""
    chan_a, chan_b = str(tmp_path / "a"), str(tmp_path / "b")
    _csv_channel(chan_a, n_files=2, rows=200, seed=1)
    _csv_channel(chan_b, n_files=2, rows=210, seed=9)
    for fn, smod in ((_ingest, streaming), (_jax_ingest, jax_streaming)):
        _results, errors = _two_ranks(fn, [chan_a, chan_b], shard=True)
        assert set(errors) == {0, 1}
        for e in errors.values():
            assert isinstance(e, smod.IngestError) and e.reason == "plan_divergence"


def test_local_failure_reaches_every_rank(tmp_path):
    """A rank that fails before the exchange (a delimiter mismatch) still
    joins it, and both ranks raise its UserError."""
    good, bad = str(tmp_path / "good"), str(tmp_path / "bad")
    _csv_channel(good, n_files=1)
    os.makedirs(bad)
    with open(os.path.join(bad, "a.csv"), "w") as f:
        f.write("1,2,3\n0,4,5\n")
    with open(os.path.join(bad, "b.csv"), "w") as f:
        f.write("1;2;3\n0;4;5\n")
    _results, errors = _two_ranks(_ingest, [good, bad])
    assert set(errors) == {0, 1}
    assert all(isinstance(e, exc.UserError) and "delimiter" in str(e) for e in errors.values())


ENTRY = textwrap.dedent("""
    import os
    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, entry
    real = algorithm_train.train_job

    def train_job(*args, **kwargs):
        bst = real(*args, **kwargs)
        bst.save_model(os.environ["MODEL_COPY"])   # every rank's model
        return bst

    algorithm_train.train_job = train_job
    entry.main(device="cpu")
""")


def test_two_hosts_entry_chunked(tmp_path):
    """Two hosts of the entry point with ``SM_INGEST_MODE=chunked`` and
    unevenly split channels: both exit 0 with identical metric lines and
    byte-equal models, each within 2e-3 of the one-host chunked run's
    validation logloss."""
    X_all, y_all = [], []
    for seed in (0, 1, 2):
        y, X = _rows(500, 6, seed)
        X_all.append(X)
        y_all.append(y)
    X, y = np.concatenate(X_all), np.concatenate(y_all)
    split, vsplit, n_val = 900, 150, 300
    Xv, yv = X[-n_val:], y[-n_val:]
    X, y = X[:-n_val], y[:-n_val]

    def write(path, Xp, yp):
        os.makedirs(path)
        with open(os.path.join(path, "data.csv"), "w") as f:
            for label, row in zip(yp, Xp):
                f.write(",".join(["%g" % label] + ["" if np.isnan(v) else "%.6g" % v
                                                   for v in row]) + "\n")

    ports = {k: str(free_port()) for k in ("SM_RENDEZVOUS_PORT", "SM_PROCESS_GROUP_PORT",
                                            "SM_HEARTBEAT_PORT", "SM_FLEET_TRACE_PORT",
                                            "SM_INGEST_PORT")}
    hosts = ["127.0.0.1", "localhost"]
    procs = []
    for rank in range(2):
        root = str(tmp_path / "host{}".format(rank))
        t = slice(0, split) if rank == 0 else slice(split, None)
        v = slice(0, vsplit) if rank == 0 else slice(vsplit, None)
        write(os.path.join(root, "train"), X[t], y[t])
        write(os.path.join(root, "validation"), Xv[v], yv[v])
        with open(os.path.join(root, "hp.json"), "w") as f:
            json.dump(HP, f)
        with open(os.path.join(root, "data.json"), "w") as f:
            json.dump({"train": CHANNEL, "validation": dict(CHANNEL)}, f)
        env = {k: v for k, v in os.environ.items() if not k.startswith(("SM_", "SAGEMAKER_"))}
        env.update(ports)
        env.update({
            "SM_INPUT_TRAINING_CONFIG_FILE": os.path.join(root, "hp.json"),
            "SM_INPUT_DATA_CONFIG_FILE": os.path.join(root, "data.json"),
            "SM_CHECKPOINT_CONFIG_FILE": os.path.join(root, "none.json"),
            "SM_CHANNEL_TRAIN": os.path.join(root, "train"),
            "SM_CHANNEL_VALIDATION": os.path.join(root, "validation"),
            "SM_MODEL_DIR": os.path.join(root, "model"),
            "SM_OUTPUT_DIR": os.path.join(root, "output"),
            "SM_OUTPUT_DATA_DIR": os.path.join(root, "output", "data"),
            "SM_HOSTS": json.dumps(hosts), "SM_CURRENT_HOST": hosts[rank],
            "SM_ABORT_PORT": str(free_port()),
            "SM_INGEST_MODE": "chunked", "SM_INGEST_CHUNK_BYTES": "8192",
            "GRAFT_HEARTBEAT_TIMEOUT_S": "60",
            "MODEL_COPY": os.path.join(root, "model-copy.json"),
            "PYTHONPATH": REPO,
        })
        procs.append((subprocess.Popen([sys.executable, "-c", ENTRY], env=env, cwd=root,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), root))
    outs = []
    try:
        for p, root in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err, root))
    finally:
        for p, _root in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)
    for code, _out, err, _root in outs:
        assert code == 0, err[-3000:]
    lines = [[l for l in out.splitlines() if re.match(r"^\[\d+\]\t", l)]
             for _c, out, _e, _r in outs]
    assert len(lines[0]) == 5 and lines[0] == lines[1]
    copies = []
    for _c, _o, _e, root in outs:
        with open(os.path.join(root, "model-copy.json"), "rb") as f:
            copies.append(f.read())
    with open(os.path.join(outs[0][3], "model", "xgboost-model"), "rb") as f:
        assert f.read() == copies[0] == copies[1]
    # the one-host chunked run over all the rows
    tdir, vdir = str(tmp_path / "one" / "train"), str(tmp_path / "one" / "validation")
    write(tdir, X, y)
    write(vdir, Xv, yv)
    os.environ["SM_INGEST_MODE"] = "chunked"
    try:
        one = _sagemaker_train(tmp_path, "one-model", tdir, vdir)
    finally:
        del os.environ["SM_INGEST_MODE"]
    forest = Forest.load_model(os.path.join(one, "xgboost-model"), device="cpu")
    two = Forest.load_model(os.path.join(outs[0][3], "model", "xgboost-model"), device="cpu")

    def logloss(f):
        p = np.clip(np.asarray(f.predict(Xv), np.float64), 1e-7, 1 - 1e-7)
        return float(-np.mean(yv * np.log(p) + (1 - yv) * np.log(1 - p)))

    assert abs(logloss(two) - logloss(forest)) <= 2e-3 * max(1.0, logloss(forest))


# ---------------------------------------------------- bounded memory
_MEM_CHILD = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    mode, channel = sys.argv[1], sys.argv[2]
    from sagemaker_xgboost_container_tpu_torch.data import binning, readers, streaming
    # tracemalloc counts the numpy buffers that dominate both paths (the
    # float matrix, the per-chunk blocks, the bins), apart from the
    # interpreter's and torch's import footprint
    import tracemalloc

    tracemalloc.start()
    tracemalloc.reset_peak()
    if mode == "whole":
        binned = binning.bin_matrix(readers.get_data_matrix(channel, "text/csv"), 256)
    else:
        cfg = streaming.resolve_ingest_config()
        cfg.chunk_bytes = 256 * 1024
        binned = streaming.ingest_channel(channel, "text/csv", 256, config=cfg, device="cpu")
    _current, peak = tracemalloc.get_traced_memory()
    print(json.dumps({{"peak_kb": peak // 1024, "rows": binned.num_row}}))
""")


def _mem_child(mode, channel):
    out = subprocess.run([sys.executable, "-c", _MEM_CHILD.format(repo=REPO), mode, channel],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_bounded_memory_proof(tmp_path):
    """A channel many chunks long: the chunked path's traced peak is
    O(chunk + sketch + binned rows), the whole-file path's O(float32
    dataset) and more."""
    channel = tmp_path / "big"
    channel.mkdir()
    d, block_rows, repeats = 16, 20000, 10
    rng = np.random.RandomState(0)
    block = np.column_stack([rng.randint(0, 2, block_rows),
                             rng.rand(block_rows, d).round(3)]).astype(np.float32)
    import io

    buf = io.BytesIO()
    np.savetxt(buf, block, delimiter=",", fmt="%.6g")
    with open(channel / "train.csv", "wb") as f:
        for _ in range(repeats):
            f.write(buf.getvalue())
    n_rows = block_rows * repeats
    float_kb = n_rows * d * 4 // 1024
    whole = _mem_child("whole", str(channel))
    chunked = _mem_child("chunked", str(channel))
    assert whole["rows"] == chunked["rows"] == n_rows
    assert whole["peak_kb"] > 2.0 * float_kb, (whole, float_kb)
    assert chunked["peak_kb"] < 0.4 * whole["peak_kb"], (chunked, whole)
    assert chunked["peak_kb"] < 1.2 * float_kb, (chunked, float_kb)
