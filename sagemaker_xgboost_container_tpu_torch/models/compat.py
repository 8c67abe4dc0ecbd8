"""Model-file formats beyond the xgboost JSON of ``Forest.load_json``.

Customers bring ``xgboost-model`` files saved by real xgboost as

* xgboost JSON (``Forest.from_dict``),
* xgboost UBJSON: the draft-12 UBJ encoding of the same document, the
  default ``save_model`` format since xgboost 2.x (decoded here),
* the legacy binary format or a pickled ``xgboost.core.Booster``: not
  loaded by this package yet; both raise a ``UserError`` naming the format.
"""

import io
import json
import struct

import numpy as np

from ..toolkit import exceptions as exc
from .forest import Forest

XGB_FORMAT = "xgb_format"


# ---------------------------------------------------------------------------
# UBJSON (draft-12, the subset xgboost emits)
# ---------------------------------------------------------------------------

# UBJSON numbers are big-endian (draft-12 spec)
_UBJ_INT_TYPES = {
    b"i": ("b", 1),
    b"U": ("B", 1),
    b"I": (">h", 2),
    b"u": (">H", 2),
    b"l": (">i", 4),
    b"m": (">I", 4),
    b"L": (">q", 8),
    b"M": (">Q", 8),
}
_UBJ_FLOAT_TYPES = {b"d": (">f", 4), b"D": (">d", 8)}
_UBJ_NUMPY_TYPES = {
    b"i": "b", b"U": "B", b"I": ">i2", b"u": ">u2",
    b"l": ">i4", b"m": ">u4", b"L": ">i8", b"M": ">u8",
    b"d": ">f4", b"D": ">f8",
}


class _UbjReader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n):
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated UBJSON")
        self.pos += n
        return out

    def peek(self):
        return self.buf[self.pos : self.pos + 1]

    def read_marker(self):
        marker = self.take(1)
        while marker == b"N":  # no-op
            marker = self.take(1)
        return marker

    def read_int(self, marker=None):
        marker = marker or self.read_marker()
        spec = _UBJ_INT_TYPES.get(marker)
        if spec is None:
            raise ValueError("expected UBJ int, got {!r}".format(marker))
        fmt, size = spec
        return struct.unpack(fmt, self.take(size))[0]

    def read_string(self):
        return self.take(self.read_int()).decode("utf-8")

    def read_value(self, marker=None):
        marker = marker or self.read_marker()
        if marker in _UBJ_INT_TYPES:
            return self.read_int(marker)
        if marker in _UBJ_FLOAT_TYPES:
            fmt, size = _UBJ_FLOAT_TYPES[marker]
            return struct.unpack(fmt, self.take(size))[0]
        if marker == b"S":
            return self.read_string()
        if marker == b"C":
            return self.take(1).decode("latin-1")
        if marker == b"T":
            return True
        if marker == b"F":
            return False
        if marker == b"Z":
            return None
        if marker == b"[":
            return self._read_array()
        if marker == b"{":
            return self._read_object()
        raise ValueError("unsupported UBJ marker {!r}".format(marker))

    def _read_array(self):
        el_type = None
        count = None
        if self.peek() == b"$":
            self.take(1)
            el_type = self.take(1)
        if self.peek() == b"#":
            self.take(1)
            count = self.read_int()
        if el_type is not None and count is not None:
            if el_type in _UBJ_NUMPY_TYPES:
                dtype = np.dtype(_UBJ_NUMPY_TYPES[el_type])
                raw = self.take(dtype.itemsize * count)
                return np.frombuffer(raw, dtype=dtype).tolist()
            return [self.read_value(el_type) for _ in range(count)]
        if count is not None:
            return [self.read_value() for _ in range(count)]
        out = []
        while self.peek() != b"]":
            out.append(self.read_value())
        self.take(1)
        return out

    def _read_object(self):
        count = None
        if self.peek() == b"$":
            raise ValueError("typed UBJ objects unsupported")
        if self.peek() == b"#":
            self.take(1)
            count = self.read_int()
        out = {}
        if count is not None:
            for _ in range(count):
                key = self.read_string()
                out[key] = self.read_value()
            return out
        while self.peek() != b"}":
            key = self.read_string()
            out[key] = self.read_value()
        self.take(1)
        return out


def decode_ubjson(buf):
    return _UbjReader(buf).read_value()


def _ubj_int(value):
    if -128 <= value <= 127:
        return b"i" + struct.pack("b", value)
    if 0 <= value <= 255:
        return b"U" + struct.pack("B", value)
    if -(2**15) <= value < 2**15:
        return b"I" + struct.pack(">h", value)
    if -(2**31) <= value < 2**31:
        return b"l" + struct.pack(">i", value)
    return b"L" + struct.pack(">q", value)


def _ubj_str_payload(s):
    raw = s.encode("utf-8")
    return _ubj_int(len(raw)) + raw


def encode_ubjson(obj):
    """Draft-12 UBJSON encoder for the subset the model document uses."""
    out = io.BytesIO()

    def write(o):
        if o is None:
            out.write(b"Z")
        elif o is True:
            out.write(b"T")
        elif o is False:
            out.write(b"F")
        elif isinstance(o, (int, np.integer)):
            out.write(_ubj_int(int(o)))
        elif isinstance(o, (float, np.floating)):
            out.write(b"D" + struct.pack(">d", float(o)))
        elif isinstance(o, str):
            out.write(b"S" + _ubj_str_payload(o))
        elif isinstance(o, dict):
            out.write(b"{")
            for key, value in o.items():
                out.write(_ubj_str_payload(str(key)))
                write(value)
            out.write(b"}")
        elif isinstance(o, (list, tuple, np.ndarray)):
            seq = list(o)
            if seq and all(isinstance(v, (float, np.floating)) for v in seq):
                out.write(b"[$D#" + _ubj_int(len(seq)))
                out.write(struct.pack(">{}d".format(len(seq)), *map(float, seq)))
            else:
                out.write(b"[")
                for v in seq:
                    write(v)
                out.write(b"]")
        else:
            raise TypeError("cannot UBJSON-encode {!r}".format(type(o)))

    write(obj)
    return out.getvalue()


# ---------------------------------------------------------------------------
# Dispatch by format
# ---------------------------------------------------------------------------


def _forest_from_raw(raw, device=None):
    """Dispatch a raw model buffer by magic."""
    raw = bytes(raw)
    if raw[:14] == b"CONFIG-offset:":
        raise exc.UserError(
            "legacy binary xgboost models are not supported by the PyTorch port yet"
        )
    head = raw.lstrip()[:1]
    if head == b"{" and raw[1:2] not in (b"L", b"l", b"i", b"U", b"I", b"#", b"$"):
        return Forest.from_dict(json.loads(raw.decode("utf-8")), device=device)
    if raw[:1] == b"{":
        return Forest.from_dict(decode_ubjson(raw), device=device)
    if raw[:1] == b"\x80":  # pickle protocol 2 and later
        raise exc.UserError(
            "pickled xgboost Booster models are not supported by the PyTorch port yet"
        )
    raise exc.UserError(
        "legacy binary xgboost models are not supported by the PyTorch port yet"
    )


def load_model_any_format(path, device=None):
    """-> (Forest on ``device``, source format tag). xgboost JSON and UBJSON
    load; the legacy binary and pickle formats raise a UserError naming the
    format."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return _forest_from_raw(raw, device=device), XGB_FORMAT
    except exc.UserError:
        raise
    except (ValueError, KeyError, TypeError) as e:
        raise RuntimeError(
            "Model {} cannot be loaded as JSON or UBJSON: {}".format(path, e)
        )
