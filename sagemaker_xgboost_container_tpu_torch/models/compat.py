"""Model-file formats beyond the xgboost JSON of ``Forest.load_json``.

Customers bring ``xgboost-model`` files saved by real xgboost as

* xgboost JSON (``Forest.from_dict`` for gbtree and dart documents,
  ``gblinear.LinearModel.from_dict`` for gblinear ones),
* xgboost UBJSON: the draft-12 UBJ encoding of the same document, the
  default ``save_model`` format since xgboost 2.x (decoded here),
* the legacy binary format (xgboost's pre-1.0 packed C structs),
* a pickled ``xgboost.core.Booster``, unpickled through a stub module (no
  xgboost import), whose ``handle`` buffer holds the legacy binary with a
  ``CONFIG-offset:`` JSON trailer, UBJSON or JSON.

``load_model_any_format`` probes them in the reference container's order:
pickle first, then the raw formats.
"""

import io
import json
import pickle
import struct
import sys
import types

import numpy as np

from .._device import resolve_device
from ..toolkit import exceptions as exc
from .forest import Forest, Tree
from .gblinear import LinearModel

PKL_FORMAT = "pkl_format"
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
# Legacy binary model format (xgboost's "deprecated" serialization)
# ---------------------------------------------------------------------------


def _parse_legacy_binary(buf, device=None):
    """Packed-struct model reader, in the JAX package's layout:
    LearnerModelParam (136 bytes), the objective and booster names,
    GBTreeModelParam (160 bytes), then a tree at a time TreeParam (148
    bytes), Node (20 bytes) x n and RTreeNodeStat (16 bytes) x n, then the
    extra attributes when ``contain_extra_attrs`` is set. Like the JAX
    parser it reads no per-tree ``tree_info`` and no dart ``weight_drop``
    after the trees."""
    r = io.BytesIO(buf)
    if buf[:4] == b"binf":
        r.read(4)
    base_score, num_feature, num_class, contain_extra_attrs, _contain_eval_metrics = (
        struct.unpack("<fIiii", r.read(20)))
    r.read(116)  # major, minor, reserved[27]
    (len_obj,) = struct.unpack("<Q", r.read(8))
    name_obj = r.read(len_obj).decode()
    (len_gbm,) = struct.unpack("<Q", r.read(8))
    name_gbm = r.read(len_gbm).decode()
    if name_gbm not in ("gbtree", "dart"):
        raise exc.UserError(
            "Legacy binary model with booster '{}' is not supported".format(name_gbm))
    num_trees, _roots, _feat, _pad = struct.unpack("<iiii", r.read(16))
    r.read(8)  # num_pbuffer
    num_output_group, _size_leaf_vector = struct.unpack("<ii", r.read(8))
    r.read(128)  # reserved[32]

    forest = Forest(objective_name=name_obj, base_score=base_score,
                    num_feature=int(num_feature), num_class=max(0, int(num_class)),
                    device=device)
    for _ in range(num_trees):
        _roots, num_nodes = struct.unpack("<ii", r.read(8))
        r.read(140)  # num_deleted, max_depth, num_feature, size_leaf_vector, reserved[31]
        node = np.frombuffer(r.read(20 * num_nodes), dtype="<i4").reshape(num_nodes, 5).T.copy()
        stat = np.frombuffer(r.read(16 * num_nodes), dtype="<f4").reshape(num_nodes, 4).T.copy()
        parent, cleft, cright = node[0], node[1], node[2]
        sindex = node[3].view("<u4")
        info = node[4].view("<f4")
        is_leaf = cleft == -1
        forest.trees.append(Tree(
            feature=np.where(is_leaf, 0, (sindex & 0x7FFFFFFF).astype(np.int32)),
            threshold=np.where(is_leaf, 0.0, info),
            default_left=(sindex >> 31).astype(bool),
            left=cleft,
            right=cright,
            value=np.where(is_leaf, info, 0.0),
            base_weight=stat[2],
            gain=stat[0],
            sum_hess=stat[1],
            parent=np.where(parent < 0, 2147483647, parent & 0x7FFFFFFF),
        ))
    if num_output_group <= 0:
        # some writers leave num_output_group 0: the learner's num_class holds
        num_output_group = max(1, num_class)
    groups = max(1, num_output_group)
    forest.tree_info = [i % groups for i in range(num_trees)]
    forest.iteration_indptr = list(range(0, num_trees + 1, groups))
    if forest.iteration_indptr[-1] != num_trees:
        forest.iteration_indptr.append(num_trees)
    if contain_extra_attrs:
        try:
            (count,) = struct.unpack("<Q", r.read(8))
            for _ in range(count):
                (klen,) = struct.unpack("<Q", r.read(8))
                key = r.read(klen).decode()
                (vlen,) = struct.unpack("<Q", r.read(8))
                forest.attributes[key] = r.read(vlen).decode()
        except (struct.error, UnicodeDecodeError):
            pass
    return forest


# ---------------------------------------------------------------------------
# Pickled xgboost.core.Booster
# ---------------------------------------------------------------------------


class _StubBooster:
    """Unpickle target standing in for xgboost.core.Booster."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __reduce__(self):  # never re-pickle the stub
        raise TypeError("stub booster cannot be pickled")


def _install_xgboost_stub():
    """Register stub ``xgboost`` modules for unpickling. Where an
    ``xgboost`` module is present already (the real one, or another
    package's stub) it stays, and the unpickled object is read through its
    ``__dict__`` alone."""
    if "xgboost" in sys.modules:
        return
    xgb = types.ModuleType("xgboost")
    core = types.ModuleType("xgboost.core")
    sklearn_mod = types.ModuleType("xgboost.sklearn")
    core.Booster = _StubBooster
    xgb.Booster = _StubBooster
    for cls_name in ("XGBRegressor", "XGBClassifier", "XGBRanker", "XGBModel"):
        setattr(sklearn_mod, cls_name, type(cls_name, (_StubBooster,), {}))
    xgb.core = core
    xgb.sklearn = sklearn_mod
    sys.modules["xgboost"] = xgb
    sys.modules["xgboost.core"] = core
    sys.modules["xgboost.sklearn"] = sklearn_mod


def _forest_from_pickle(path, device=None):
    """A pickled Booster -> the model of its ``handle`` buffer, with the
    pickled state's ``feature_names`` and ``best_iteration``."""
    _install_xgboost_stub()
    with open(path, "rb") as f:
        obj = pickle.load(f)
    state = getattr(obj, "__dict__", None)
    if not state or "handle" not in state:
        raise exc.UserError("Pickled object is not an xgboost Booster")
    forest = _forest_from_raw(state["handle"], device=device)
    if state.get("feature_names"):
        forest.feature_names = list(state["feature_names"])
    best_it = state.get("best_iteration")
    if best_it is not None and not isinstance(best_it, (dict, list)):
        try:
            forest.attributes.setdefault("best_iteration", str(int(best_it)))
        except (TypeError, ValueError):
            pass
    return forest


# ---------------------------------------------------------------------------
# Dispatch by format
# ---------------------------------------------------------------------------


def _model_from_dict(doc, device=None):
    """A decoded model document -> LinearModel for gblinear, else Forest
    (gbtree, and dart with its weight_drop)."""
    name = doc.get("learner", {}).get("gradient_booster", {}).get("name", "gbtree")
    if name == "gblinear":
        return LinearModel.from_dict(doc, device=device)
    return Forest.from_dict(doc, device=device)


def _forest_from_raw(raw, device=None):
    """Dispatch a raw model buffer by magic: the legacy binary behind a
    ``CONFIG-offset:`` header (with the objective of its JSON trailer),
    JSON, UBJSON, else the legacy binary."""
    raw = bytes(raw)
    if raw[:14] == b"CONFIG-offset:":
        (offset,) = struct.unpack("<Q", raw[14:22])
        body = raw[22:]
        forest = _parse_legacy_binary(body[:offset], device=device)
        try:
            config = json.loads(body[offset:].decode("utf-8", errors="ignore") or "{}")
            obj_name = config.get("learner", {}).get("objective", {}).get("name")
            if obj_name:
                forest.objective_name = obj_name
        except ValueError:
            pass
        return forest
    head = raw.lstrip()[:1]
    if head == b"{" and raw[1:2] not in (b"L", b"l", b"i", b"U", b"I", b"#", b"$"):
        return _model_from_dict(json.loads(raw.decode("utf-8")), device=device)
    if raw[:1] == b"{":
        return _model_from_dict(decode_ubjson(raw), device=device)
    return _parse_legacy_binary(raw, device=device)


def load_model_any_format(path, device=None):
    """-> (model on ``device``, format tag): a Forest (gbtree or dart) or a
    LinearModel (gblinear), from a pickled Booster (PKL_FORMAT) or else a
    JSON, UBJSON or legacy-binary file (XGB_FORMAT), in the reference's
    probe order. Raises RuntimeError when no format loads it."""
    device = resolve_device(device)
    try:
        return _forest_from_pickle(path, device=device), PKL_FORMAT
    except Exception:
        pass
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return _forest_from_raw(raw, device=device), XGB_FORMAT
    except Exception as e:
        raise RuntimeError(
            "Model {} cannot be loaded as pickle, JSON, UBJSON, or legacy binary: {}".format(
                path, e))
