"""RecordIO-framed aialgs protobuf reader and writer.

Wire format (public SageMaker spec): each record is ``<magic u32 LE =
0xCED7230A> <length u32 LE> <payload> <pad to 4 bytes>``; the payload is an
``aialgs.data.Record`` protobuf (schema in ``native/proto/record.proto``)
whose ``features["values"]`` tensor is dense (values only) or sparse (values
+ keys + shape).

The protobuf wire codec for that one schema is written out here, so the
package needs no protobuf runtime:

* ``Record``: map fields ``features`` = 1 and ``label`` = 2, each entry a
  message with key = 1 (string) and value = 2 (``Value``); ``uid`` = 3,
  ``metadata`` = 4, ``configuration`` = 5 are skipped.
* ``Value``: a oneof of ``float32_tensor`` = 2, ``float64_tensor`` = 3,
  ``int32_tensor`` = 7 and ``bytes`` = 9; the last arm on the wire wins, a
  repeated arm merges.
* tensors: ``values`` = 1, ``keys`` = 2, ``shape`` = 3, declared packed. The
  decoder also takes them unpacked, as every proto2 parser does, and skips
  fields it does not know. The writer emits packed fields.

The reader returns (features, labels): features a dense ndarray or a CSR
matrix, labels an ndarray or None. Serving writes recordio-protobuf
responses with the writer.
"""

import collections
import struct

import numpy as np
import scipy.sparse as sp

from ..toolkit import exceptions as exc

RECORDIO_MAGIC = 0xCED7230A
_HEADER = struct.Struct("<II")

# protobuf wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_FIXED_SIZE = {_I64: 8, _I32: 4}

# Value's tensor arms: field number -> (values dtype, wire type of one
# unpacked value)
_TENSOR_ARMS = {
    2: (np.dtype("<f4"), _I32),
    3: (np.dtype("<f8"), _I64),
    7: (np.dtype(np.int32), _VARINT),
}
_BYTES_ARM = 9

Tensor = collections.namedtuple("Tensor", ["values", "keys", "shape"])
Tensor.__doc__ = """A decoded tensor arm: values in the arm's dtype, keys and
shape as int64 arrays."""


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def _record_spans(buf):
    """Yield (start, stop) of each RecordIO payload in ``buf``."""
    offset, total = 0, len(buf)
    while offset + _HEADER.size <= total:
        magic, length = _HEADER.unpack_from(buf, offset)
        if magic != RECORDIO_MAGIC:
            raise exc.UserError(
                "Invalid RecordIO magic at offset {}: 0x{:08x}".format(offset, magic)
            )
        offset += _HEADER.size
        if offset + length > total:
            raise exc.UserError("Truncated RecordIO record at offset {}".format(offset))
        yield offset, offset + length
        offset += (length + 3) & ~3


def iter_records(buf):
    """Yield raw protobuf payloads from a RecordIO byte buffer."""
    for start, stop in _record_spans(buf):
        yield buf[start:stop]


def _frame(payload):
    pad = b"\x00" * ((4 - len(payload) % 4) % 4)
    return _HEADER.pack(RECORDIO_MAGIC, len(payload)) + payload + pad


# ---------------------------------------------------------------------------
# Protobuf decoding
# ---------------------------------------------------------------------------


def _malformed(what):
    return exc.UserError("Malformed RecordIO-Protobuf record: {}".format(what))


def _varint(buf, pos, end):
    result = shift = 0
    while True:
        if pos >= end:
            raise _malformed("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise _malformed("varint longer than 10 bytes")


def _fields(buf, pos, end):
    """Yield (field number, wire type, value) of the message in buf[pos:end].
    The value is an int for varints and the (start, stop) span of the bytes
    for every other wire type."""
    while pos < end:
        key, pos = _varint(buf, pos, end)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, pos = _varint(buf, pos, end)
        else:
            if wire == _LEN:
                size, pos = _varint(buf, pos, end)
            elif wire in _FIXED_SIZE:
                size = _FIXED_SIZE[wire]
            else:
                raise _malformed("unsupported wire type {}".format(wire))
            if pos + size > end:
                raise _malformed("truncated field {}".format(field))
            value = (pos, pos + size)
            pos += size
        if field == 0:
            raise _malformed("field number 0")
        yield field, wire, value


def _packed_varints(buf, span):
    pos, end = span
    out = []
    while pos < end:
        value, pos = _varint(buf, pos, end)
        out.append(value)
    return out


def _as_int32(varints):
    # int32 travels sign-extended to 64 bits: keep the low 32 bits
    return np.asarray([v & 0xFFFFFFFF for v in varints], np.uint32).view(np.int32)


def _parse_tensor(buf, span, dtype, unpacked_wire, acc):
    """Append the tensor message's values/keys/shape chunks to ``acc``."""
    values, keys, shape = acc
    for field, wire, value in _fields(buf, *span):
        if field == 1:
            if wire == _LEN:
                if unpacked_wire == _VARINT:
                    values.append(_as_int32(_packed_varints(buf, value)))
                else:
                    start, stop = value
                    if (stop - start) % dtype.itemsize:
                        raise _malformed("packed values of a partial width")
                    if stop > start:
                        values.append(np.frombuffer(
                            buf, dtype, (stop - start) // dtype.itemsize, start))
            elif wire == unpacked_wire:
                if wire == _VARINT:
                    values.append(_as_int32([value]))
                else:
                    values.append(np.frombuffer(buf, dtype, 1, value[0]))
        elif field in (2, 3):
            out = keys if field == 2 else shape
            if wire == _LEN:
                out.extend(_packed_varints(buf, value))
            elif wire == _VARINT:
                out.append(value)


def _parse_value(buf, spans):
    """A ``Value`` from the spans of its message (several when the entry
    repeats it: protobuf merges them) -> Tensor, or None for a bytes or
    empty arm."""
    arm, acc = None, None
    for span in spans:
        for field, wire, value in _fields(buf, *span):
            if wire != _LEN or (field not in _TENSOR_ARMS and field != _BYTES_ARM):
                continue
            if field != arm:
                arm, acc = field, ([], [], [])
            if field in _TENSOR_ARMS:
                _parse_tensor(buf, value, *_TENSOR_ARMS[field], acc)
    if arm not in _TENSOR_ARMS:
        return None
    dtype = _TENSOR_ARMS[arm][0]
    values, keys, shape = acc
    return Tensor(
        np.concatenate(values) if values else np.empty(0, dtype),
        np.asarray(keys, np.uint64).astype(np.int64),
        np.asarray(shape, np.uint64).astype(np.int64),
    )


def _parse_entry(buf, span):
    """A map entry -> (key, Value spans)."""
    key, values = "", []
    for field, wire, value in _fields(buf, *span):
        if wire != _LEN:
            continue
        if field == 1:
            key = bytes(buf[value[0]:value[1]]).decode("utf-8")
        elif field == 2:
            values.append(value)
    return key, values


def parse_record(payload, start=0, stop=None):
    """Decode one ``aialgs.data.Record`` -> {"features": {name: Tensor or
    None}, "label": {name: Tensor or None}}. A later entry of a map key
    replaces an earlier one."""
    stop = len(payload) if stop is None else stop
    entries = {1: {}, 2: {}}
    for field, wire, value in _fields(payload, start, stop):
        if field in entries and wire == _LEN:
            key, spans = _parse_entry(payload, value)
            entries[field][key] = spans
    return {
        name: {key: _parse_value(payload, spans) for key, spans in entries[field].items()}
        for name, field in (("features", 1), ("label", 2))
    }


def read_recordio_protobuf(buf):
    """Decode a RecordIO-protobuf buffer into (features, labels)."""
    buf = bytes(buf)
    dense_rows = []
    sparse_vals, sparse_keys, sparse_indptr = [], [], [0]
    labels = []
    any_sparse = False
    ncols_seen = 0

    for start, stop in _record_spans(buf):
        record = parse_record(buf, start, stop)
        tensor = record["features"].get("values")
        if tensor is None:
            continue
        values, keys, shape = tensor

        if len(keys) or len(shape):
            # sparse row (keys present, or an explicitly-shaped empty row)
            any_sparse = True
            sparse_vals.append(values.astype(np.float32, copy=False))
            sparse_keys.append(keys)
            sparse_indptr.append(sparse_indptr[-1] + len(keys))
            if len(shape):
                ncols_seen = max(ncols_seen, int(shape[0]))
            elif len(keys):
                ncols_seen = max(ncols_seen, int(keys.max()) + 1)
        else:
            dense_rows.append(values.astype(np.float32, copy=False))
            ncols_seen = max(ncols_seen, len(values))

        label = record["label"].get("values")
        if label is not None:
            labels.append(label.values)

    if not dense_rows and not sparse_vals:
        raise exc.UserError("No records found in RecordIO-Protobuf data")

    if any_sparse:
        if dense_rows:
            raise exc.UserError("Mixed dense and sparse records in RecordIO-Protobuf data")
        features = sp.csr_matrix(
            (np.concatenate(sparse_vals), np.concatenate(sparse_keys),
             np.asarray(sparse_indptr)),
            shape=(len(sparse_indptr) - 1, max(ncols_seen, 1)),
        )
    else:
        features = np.vstack(dense_rows)

    label_arr = np.concatenate(labels, axis=None) if labels else None
    return features, label_arr


# ---------------------------------------------------------------------------
# Protobuf encoding
# ---------------------------------------------------------------------------


def _varint_bytes(value):
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _len_field(field, payload):
    return _varint_bytes(field << 3 | _LEN) + _varint_bytes(len(payload)) + payload


def encode_float32_tensor(values, keys=(), shape=()):
    """A ``Float32Tensor`` message, packed fields, empty fields omitted."""
    out = b""
    values = np.asarray(values, "<f4").ravel()
    if values.size:
        out += _len_field(1, values.tobytes())
    for field, ints in ((2, keys), (3, shape)):
        if len(ints):
            out += _len_field(field, b"".join(_varint_bytes(int(v)) for v in ints))
    return out


def encode_record(features=None, label=None):
    """A ``Record`` message from {name: Float32Tensor message bytes} maps."""
    out = []
    for field, tensors in ((1, features), (2, label)):
        for name, tensor in (tensors or {}).items():
            value = _len_field(2, tensor)  # Value.float32_tensor
            out.append(_len_field(field, _len_field(1, name.encode("utf-8"))
                                  + _len_field(2, value)))
    return b"".join(out)


def write_recordio_protobuf(features, labels=None):
    """Encode rows (dense or CSR) and optional per-row labels into a
    RecordIO-protobuf byte buffer."""
    is_sparse = sp.issparse(features)
    if is_sparse:
        features = features.tocsr()
    out = []
    for i in range(features.shape[0]):
        if is_sparse:
            lo, hi = features.indptr[i], features.indptr[i + 1]
            tensor = encode_float32_tensor(
                features.data[lo:hi], features.indices[lo:hi], (features.shape[1],))
        else:
            tensor = encode_float32_tensor(np.asarray(features[i]))
        label = {}
        if labels is not None:
            label["values"] = encode_float32_tensor(np.atleast_1d(labels[i]))
        out.append(_frame(encode_record({"values": tensor}, label)))
    return b"".join(out)
