"""The port's recordio-protobuf codec (``data/recordio.py``, a hand-written
protobuf wire codec) against the JAX package's reader and writer, which use
the generated ``record_pb2``."""

import struct

import numpy as np
import pytest
import scipy.sparse as sp

from sagemaker_xgboost_container_tpu.data import record_pb2
from sagemaker_xgboost_container_tpu.data import recordio as jax_recordio
from sagemaker_xgboost_container_tpu_torch.data import recordio
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc


def _dense(n=40, d=7, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[rng.rand(n, d) < 0.1] = np.nan
    return X


def _sparse(n=30, d=9, seed=1):
    S = sp.random(n, d, density=0.3, random_state=seed, format="csr", dtype=np.float32)
    S.data[:] = np.random.RandomState(seed).randn(S.nnz)
    return S


def _labels(n, seed=2):
    return np.random.RandomState(seed).rand(n).astype(np.float32)


def _assert_same_read(a, b):
    fa, la = a
    fb, lb = b
    assert sp.issparse(fa) == sp.issparse(fb)
    if sp.issparse(fa):
        assert fa.shape == fb.shape
        assert (fa != fb).nnz == 0
    else:
        np.testing.assert_array_equal(fa, fb)
    if la is None or lb is None:
        assert la is None and lb is None
    else:
        assert la.dtype == lb.dtype
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("with_labels", [False, True])
def test_port_reads_jax_writer_and_writes_its_bytes(layout, with_labels):
    X = _dense() if layout == "dense" else _sparse()
    y = _labels(X.shape[0]) if with_labels else None
    jax_bytes = jax_recordio.write_recordio_protobuf(X, y)
    _assert_same_read(recordio.read_recordio_protobuf(jax_bytes),
                      jax_recordio.read_recordio_protobuf(jax_bytes))
    # with one key per map the generated code's bytes are fixed: equal
    assert recordio.write_recordio_protobuf(X, y) == jax_bytes


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_jax_reads_port_writer(layout):
    X = _dense(n=12) if layout == "dense" else _sparse(n=12)
    y = _labels(12)
    ours = recordio.write_recordio_protobuf(X, y)
    _assert_same_read(jax_recordio.read_recordio_protobuf(ours),
                      recordio.read_recordio_protobuf(ours))
    for payload, ref in zip(recordio.iter_records(ours), jax_recordio.iter_records(
            jax_recordio.write_recordio_protobuf(X, y))):
        got, want = record_pb2.Record(), record_pb2.Record()
        got.ParseFromString(payload)
        want.ParseFromString(ref)
        assert got == want


def _record(arm, values, keys=(), shape=(), label=None, label_arm="float32_tensor"):
    r = record_pb2.Record()
    t = getattr(r.features["values"], arm)
    t.values.extend(values)
    t.keys.extend(keys)
    t.shape.extend(shape)
    if label is not None:
        getattr(r.label["values"], label_arm).values.extend(label)
    return r


@pytest.mark.parametrize("arm,values,label_arm,label", [
    ("float32_tensor", [1.5, -2.25, 3.0], "float32_tensor", [1.0]),
    ("float64_tensor", [1e-30, -2.5, 7.125], "float64_tensor", [0.25, 0.75]),
    ("int32_tensor", [7, -8, 2147483647], "int32_tensor", [-3]),
    ("int32_tensor", [-2147483648, 0, 5], "float64_tensor", [2.5]),
])
def test_tensor_arms_match_jax(arm, values, label_arm, label):
    recs = [_record(arm, values, label=label, label_arm=label_arm),
            _record(arm, values[::-1], label=label, label_arm=label_arm)]
    buf = b"".join(jax_recordio._frame(r.SerializeToString()) for r in recs)
    _assert_same_read(recordio.read_recordio_protobuf(buf),
                      jax_recordio.read_recordio_protobuf(buf))


def test_sparse_arms_and_explicit_shape_match_jax():
    recs = [_record("float64_tensor", [1.0, 2.0], keys=[0, 5], shape=[12]),
            _record("int32_tensor", [-4], keys=[3]),
            _record("float32_tensor", [], shape=[12])]
    buf = b"".join(jax_recordio._frame(r.SerializeToString()) for r in recs)
    _assert_same_read(recordio.read_recordio_protobuf(buf),
                      jax_recordio.read_recordio_protobuf(buf))


def _key(field, wire):
    return recordio._varint_bytes(field << 3 | wire)


def _len(field, payload):
    return _key(field, 2) + recordio._varint_bytes(len(payload)) + payload


def _unknown_fields():
    """One unknown field of each wire type, numbered where no schema uses it."""
    return (_key(15, 0) + recordio._varint_bytes(300)
            + _len(16, b"junk")
            + _key(17, 5) + b"\x01\x02\x03\x04"
            + _key(18, 1) + b"\x01" * 8)


def _hand_record(tensor, unknown=b"", entry_unknown=b""):
    value = _len(2, tensor) + unknown             # Value.float32_tensor
    entry = _len(1, b"values") + _len(2, value) + entry_unknown
    return _len(1, entry) + _len(3, b"uid-7") + _len(4, b"meta") + _len(5, b"cfg") + unknown


def test_unpacked_fields_and_unknown_fields_match_jax():
    vals = np.asarray([1.5, -0.5, 2.0], "<f4")
    # values and keys unpacked (one field each), shape packed, unknown
    # fields at every level of the message
    tensor = b"".join(_key(1, 5) + v.tobytes() for v in vals)
    tensor += b"".join(_key(2, 0) + recordio._varint_bytes(k) for k in (1, 4, 6))
    tensor += _len(3, recordio._varint_bytes(8)) + _unknown_fields()
    sparse_buf = jax_recordio._frame(_hand_record(tensor, _unknown_fields()))
    _assert_same_read(recordio.read_recordio_protobuf(sparse_buf),
                      jax_recordio.read_recordio_protobuf(sparse_buf))
    dense = b"".join(_key(1, 5) + v.tobytes() for v in vals) + _unknown_fields()
    dense_buf = jax_recordio._frame(_hand_record(dense, _unknown_fields())) * 2
    _assert_same_read(recordio.read_recordio_protobuf(dense_buf),
                      jax_recordio.read_recordio_protobuf(dense_buf))
    # an unknown field inside a map entry: the port skips the field and keeps
    # the entry (the generated parser drops the whole entry)
    entry_buf = jax_recordio._frame(_hand_record(dense, entry_unknown=_unknown_fields()))
    np.testing.assert_array_equal(recordio.read_recordio_protobuf(entry_buf)[0], [vals])


def test_unpacked_int32_and_double_values_match_jax():
    for field, wire, encode in ((3, 1, lambda v: struct.pack("<d", v)),
                                (7, 0, lambda v: recordio._varint_bytes(int(v) & (2**64 - 1)))):
        tensor = b"".join(_key(1, wire) + encode(v) for v in (-3, 0, 9))
        value = _len(field, tensor)
        payload = _len(1, _len(1, b"values") + _len(2, value))
        buf = jax_recordio._frame(payload)
        _assert_same_read(recordio.read_recordio_protobuf(buf),
                          jax_recordio.read_recordio_protobuf(buf))


def test_duplicate_map_key_last_wins_and_bytes_arm_skipped():
    first = _hand_record(_len(1, np.asarray([1.0, 2.0], "<f4").tobytes()))
    second = _hand_record(_len(1, np.asarray([3.0, 4.0], "<f4").tobytes()))
    bytes_arm = _len(1, _len(1, b"values") + _len(2, _len(9, _len(1, b"raw"))))
    buf = jax_recordio._frame(first + second) + jax_recordio._frame(bytes_arm)
    ours = recordio.read_recordio_protobuf(buf)
    _assert_same_read(ours, jax_recordio.read_recordio_protobuf(buf))
    np.testing.assert_array_equal(ours[0], [[3.0, 4.0]])


def test_framing_errors_match_jax_messages():
    good = recordio.write_recordio_protobuf(_dense(n=2))
    bad_magic = b"\x00\x00\x00\x00" + good[4:]
    truncated = good[:-6]
    for buf in (bad_magic, truncated):
        with pytest.raises(exc.UserError) as ours:
            recordio.read_recordio_protobuf(buf)
        with pytest.raises(Exception) as ref:
            jax_recordio.read_recordio_protobuf(buf)
        assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("cut", [1, 3, 9, 14])
def test_truncated_protobuf_raises_user_error(cut):
    payload = _hand_record(_len(1, np.asarray([1.0, 2.0], "<f4").tobytes()))
    with pytest.raises(exc.UserError, match="Malformed RecordIO-Protobuf"):
        recordio.read_recordio_protobuf(jax_recordio._frame(payload[:-cut]))


def test_empty_and_mixed_inputs_raise_like_jax():
    mixed = (jax_recordio.write_recordio_protobuf(_dense(n=1, d=9))
             + jax_recordio.write_recordio_protobuf(_sparse(n=1)))
    for buf in (b"", mixed):
        with pytest.raises(exc.UserError) as ours:
            recordio.read_recordio_protobuf(buf)
        with pytest.raises(Exception) as ref:
            jax_recordio.read_recordio_protobuf(buf)
        assert str(ours.value) == str(ref.value)


def test_parse_record_reads_every_map_entry():
    r = _record("float32_tensor", [1.0, 2.0], label=[5.0])
    r.label["probability"].float64_tensor.values.extend([0.25])
    r.features["other"].int32_tensor.values.extend([3])
    got = recordio.parse_record(r.SerializeToString())
    assert sorted(got["features"]) == ["other", "values"]
    assert sorted(got["label"]) == ["probability", "values"]
    np.testing.assert_array_equal(got["label"]["probability"].values, [0.25])
    assert got["label"]["probability"].values.dtype == np.float64
    np.testing.assert_array_equal(got["features"]["other"].values, [3])
