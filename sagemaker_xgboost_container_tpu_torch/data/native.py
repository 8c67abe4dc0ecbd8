"""ctypes bindings for the native data plane (``native/fastdata.cpp``).

One C++ library serves two host paths: the libsvm tokenizer of training
ingest (``readers.parse_libsvm_text``, two passes: count, then fill
preallocated numpy buffers, over newline-aligned slices on threads for a
large text) and the forest traversal of small serving payloads
(``ops/predict._host_leaf_values``). The interface is a plain C ABI driven
from ctypes, the same one the JAX package binds.

The library is found in this order: the ``_fastdata*.so`` that ``setup.py``
builds into this package, when it is not older than the source; else a
``g++ -O3 -shared -fPIC -pthread`` build of ``native/fastdata.cpp`` beside
the package, cached under ``torch_native/<key>/`` of the compile cache's
root (``utils/compile_cache``; the key digests the source, the compiler's
path and the flags). Nothing is built at import: the first parse or
predict builds it, or the serving warmup does, off the request path.

Without a compiler both paths fall back (the Python tokenizer, the numpy
traversal), with one warning a process; ``NATIVE_ROUTES`` counts which
path ran.
"""

import ctypes
import glob
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time

import numpy as np

from ..utils import compile_cache
from ..utils.envconfig import env_int

logger = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "fastdata.cpp")
_LIB_NAME = "libfastdata.so"
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]
PARSE_THREADS_ENV = "GRAFT_PARSE_THREADS"
_BYTES_PER_THREAD = 8 << 20
_MAX_THREADS = 16

# which path ran, a call each: the tokenizer (native / python) and the
# small-payload traversal (native / numpy)
NATIVE_ROUTES = {"parse_native": 0, "parse_python": 0, "predict_native": 0,
                 "predict_numpy": 0}
_routes_lock = threading.Lock()

_lock = threading.Lock()
_lib = None
_tried = False
_loaded = {}  # how the library was found: route, path, build_s


def count_route(route):
    with _routes_lock:
        NATIVE_ROUTES[route] += 1


def reset_native_routes():
    with _routes_lock:
        for key in NATIVE_ROUTES:
            NATIVE_ROUTES[key] = 0


class _LibsvmInfo(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("max_index", ctypes.c_int64),
        ("has_weights", ctypes.c_int32),
        ("has_qids", ctypes.c_int32),
        ("error_line", ctypes.c_int64),
    ]


def _packaged_extension():
    """The ``_fastdata*.so`` that ``setup.py`` builds into this package, or
    None. A plain C-ABI object: loaded with ctypes, never imported."""
    hits = sorted(glob.glob(os.path.join(_PKG_DIR, "_fastdata*.so")))
    return hits[0] if hits else None


def _resolve_lib_path():
    """("packaged", path) for the shipped library where there is no source
    or the source is not newer; else ("rebuild", None): a checkout whose
    source changed builds, so an edit takes effect."""
    packaged = _packaged_extension()
    if packaged is not None and (
        not os.path.exists(_SOURCE)
        or os.path.getmtime(_SOURCE) <= os.path.getmtime(packaged)
    ):
        return "packaged", packaged
    return "rebuild", None


def cache_dir():
    """The directory the built libraries are cached under."""
    return compile_cache.cache_dir("torch_native")


def _build_key(compiler):
    """Digest of everything the library is built from."""
    h = hashlib.sha256(" ".join([compiler] + _FLAGS).encode())
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def _built_library():
    """-> (path, seconds spent building: 0.0 when the cached library of
    these sources was there). Raises where there is no compiler or no
    source."""
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("no g++ on PATH")
    out_dir = os.path.join(cache_dir(), _build_key(compiler))
    path = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(out_dir, exist_ok=True)
    # a per-process name, then a rename: processes that build at once do
    # not write one file
    tmp = "{}.{}".format(path, os.getpid())
    t0 = time.perf_counter()
    proc = subprocess.run([compiler] + _FLAGS + ["-o", tmp, _SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("g++ failed on {}:\n{}".format(_SOURCE, proc.stderr[-2000:]))
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def _bind(lib):
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    info = ctypes.POINTER(_LibsvmInfo)
    lib.libsvm_count.restype = ctypes.c_int
    lib.libsvm_count.argtypes = [ctypes.c_char_p, i64, info]
    lib.libsvm_fill.restype = ctypes.c_int
    lib.libsvm_fill.argtypes = [ctypes.c_char_p, i64] + [p] * 6
    lib.libsvm_count_mt.restype = ctypes.c_int
    lib.libsvm_count_mt.argtypes = [ctypes.c_char_p, i64, i32, info, info]
    lib.libsvm_fill_mt.restype = ctypes.c_int
    lib.libsvm_fill_mt.argtypes = [ctypes.c_char_p, i64, i32, info] + [p] * 6
    lib.forest_leaf_values.restype = ctypes.c_int
    lib.forest_leaf_values.argtypes = [p] * 9 + [i64] * 3 + [p, i64, i64, i32, p]
    return lib


def _load():
    global _lib, _tried
    # lock-free once loaded: _lib and _tried are written only under the
    # lock, and the serving path calls this a request
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        try:
            route, path = _resolve_lib_path()
            build_s = 0.0
            if route == "rebuild":
                path, build_s = _built_library()
                route = "built" if build_s else "cached"
            _lib = _bind(ctypes.CDLL(path))
            _loaded.update(route=route, path=path, build_s=build_s)
        except (OSError, RuntimeError, AttributeError) as e:
            logger.warning("native data plane unavailable (%s): libsvm parses in Python and "
                           "small payloads traverse in numpy", e)
            _lib = None
        finally:
            # set only after the attempt: the unlocked check above must not
            # hand None to a caller while a first build runs behind the lock
            _tried = True
    return _lib


def _reset_for_tests():
    """Forget the loaded library, so that the next call loads (or builds)
    it again."""
    global _lib, _tried
    with _lock:
        _lib, _tried = None, False
        _loaded.clear()


def native_available():
    return _load() is not None


def forest_predictor_available():
    """True when the library is loaded (it carries the forest traversal
    with the tokenizer)."""
    return _load() is not None


def load_info():
    """How the library was found: {"route": "packaged" | "built" |
    "cached", "path", "build_s"}; empty before a load or after a failed
    one."""
    _load()
    return dict(_loaded)


def _parse_threads(nbytes):
    """Threads of the parallel parse: one a ~8 MB slice, at most 16 and the
    host's cores; ``GRAFT_PARSE_THREADS`` overrides (1 or less: the
    single-threaded path)."""
    forced = env_int(PARSE_THREADS_ENV, None)
    if forced is not None:
        return max(1, forced)
    return max(1, min(os.cpu_count() or 1, _MAX_THREADS, nbytes // _BYTES_PER_THREAD))


def parse_libsvm_native(data):
    """libsvm text (str or bytes) -> ((values, indices, indptr), labels,
    weights or None, qids or None), or None without the library. Raises
    ValueError naming the first malformed line (1-based, of ``data``)."""
    lib = _load()
    if lib is None:
        return None
    if isinstance(data, str):
        data = data.encode("utf-8")
    nthreads = _parse_threads(len(data))
    info = _LibsvmInfo()
    per_chunk = None
    if nthreads > 1:
        per_chunk = (_LibsvmInfo * nthreads)()
        if lib.libsvm_count_mt(data, len(data), nthreads, ctypes.byref(info), per_chunk):
            # a slice's error line is local to the slice: count again on
            # one thread for the line of the whole text
            lib.libsvm_count(data, len(data), ctypes.byref(info))
            raise ValueError("Malformed LIBSVM line {}".format(info.error_line))
    elif lib.libsvm_count(data, len(data), ctypes.byref(info)):
        raise ValueError("Malformed LIBSVM line {}".format(info.error_line))
    n, nnz = info.n_rows, info.nnz
    labels = np.empty(n, np.float32)
    weights = np.empty(n, np.float32)
    qids = np.empty(n, np.int64) if info.has_qids else None
    indices = np.empty(nnz, np.int64)
    values = np.empty(nnz, np.float32)
    indptr = np.empty(n + 1, np.int64)
    bufs = [a.ctypes.data if a is not None else None
            for a in (labels, weights, qids, indices, values, indptr)]
    if per_chunk is not None:
        rc = lib.libsvm_fill_mt(data, len(data), nthreads, per_chunk, *bufs)
    else:
        rc = lib.libsvm_fill(data, len(data), *bufs)
    if rc != 0:
        raise ValueError("Malformed LIBSVM input")
    return (values, indices, indptr), labels, weights if info.has_weights else None, qids


def _operand(stacked, key, dtype):
    """A stacked forest array as the C traversal reads it: bool as uint8
    and the int32 category words as uint32 (the same bits: free views)."""
    a = np.asarray(stacked[key])
    if a.dtype.itemsize == np.dtype(dtype).itemsize and a.dtype.kind in "biu":
        a = a.view(dtype)
    return np.ascontiguousarray(a, dtype)


def _forest_operands(stacked):
    """The cached ctypes operands of a host-stacked forest, or "invalid"
    where a node index is out of range (a corrupt model: the numpy twin
    then raises its IndexError)."""
    feature = _operand(stacked, "feature", np.int32)
    T, N = feature.shape
    left = _operand(stacked, "left", np.int32)
    right = _operand(stacked, "right", np.int32)
    if feature.size == 0 or (
        left.min() < 0 or left.max() >= N or right.min() < 0 or right.max() >= N
        or feature.min() < 0
    ):
        return "invalid"
    cat_split = cat_mask = None
    W = 0
    if "cat_split" in stacked:
        cat_split = _operand(stacked, "cat_split", np.uint8)
        cat_mask = _operand(stacked, "cat_mask", np.uint32)
        W = cat_mask.shape[2]
    arrays = (feature, _operand(stacked, "threshold", np.float32),
              _operand(stacked, "default_left", np.uint8), left, right,
              _operand(stacked, "is_leaf", np.uint8),
              _operand(stacked, "leaf_value", np.float32), cat_split, cat_mask)
    # the addresses as plain ints, computed once (``arrays`` keeps the
    # buffers alive beside them)
    ptrs = tuple(a.ctypes.data if a is not None else None for a in arrays)
    return arrays, ptrs, T, N, W, int(stacked["depth"]), int(feature.max())


def forest_leaf_values_native(stacked, x):
    """Host-stacked forest (``Forest._stack``'s numpy half) + [n, d] float32
    rows -> [n, T] leaf values of each tree by the C++ traversal, or None
    (no library, a corrupt model, or a split feature beyond the rows'
    width): the caller then runs the numpy twin.

    The operands are cached on the stacked dict under ``_native_args``, so
    a steady stream of requests converts nothing."""
    lib = _load()
    if lib is None:
        return None
    args = stacked.get("_native_args")
    if args is None:
        args = stacked["_native_args"] = _forest_operands(stacked)
    if isinstance(args, str):
        return None
    _arrays, ptrs, T, N, W, depth, fmax = args
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    if fmax >= d:
        return None
    out = np.empty((n, T), np.float32)
    # __array_interface__ over .ctypes: a few microseconds less a request
    lib.forest_leaf_values(*ptrs, T, N, W, x.__array_interface__["data"][0], n, d, depth,
                           out.__array_interface__["data"][0])
    return out
