"""Channel ingestion: staged file discovery + csv/libsvm/parquet/recordio readers.

The port's counterpart of ``sagemaker_xgboost_container_tpu/data/readers.py``,
with a DataMatrix as destination:

* symlink staging of (possibly nested) channel directories into one flat
  directory, depth-capped at MAX_FOLDER_DEPTH with a warning; the staging
  directory is private to each read and removed after it,
* data-file filtering (hidden, underscore and cache files skipped, zero-byte
  files dropped, libsvm ``.weight``/``.group`` sidecars paired with their
  data file),
* first-line format validation for csv and libsvm,
* readers: csv with a sniffed delimiter, label in column 0 (weight in column
  1 when csv_weights=1), parsed with numpy; libsvm with optional
  ``label:weight`` and ``qid:`` tokens and ``.weight``/``.group`` sidecar
  files (the native C++ tokenizer of ``data/native.py``, a Python one
  where it does not load); parquet through pyarrow, column by
  column (column 0 the label); recordio-protobuf through the port's own
  wire codec (``data/recordio.py``),
* the "no labels" UserError and the size and redundancy helpers,
* every file read under ``utils/retry.retry_transient`` (an ``OSError``
  retries with jittered backoff, counted in ``io_retries_total{site}``),
  with the ``data.read`` fault point inside the attempt.

The port depends on neither pandas nor pyarrow: pyarrow is imported only
when a parquet channel is read, and its absence is a ``UserError`` naming
it. The csv reader follows the JAX reader's
pandas semantics without pandas: empty fields and the usual NA
spellings are missing values, a row shorter than the file's first row is
padded with missing values, a longer one is an error, and files of one
channel of different widths are padded to the widest.
"""

import csv as csv_module
import io
import logging
import os
import shutil
import tempfile

import numpy as np
import scipy.sparse as sp

from ..toolkit import exceptions as exc
from ..utils.faults import fault_point
from ..utils.retry import retry_transient
from ..utils.warn_once import warn_once
from . import content_types as ct
from . import native
from .matrix import DataMatrix
from .recordio import read_recordio_protobuf

logger = logging.getLogger(__name__)


def _read_with_retries(fn, path, site):
    """One file's read under the transient-retry policy (``utils/retry.py``):
    an ``OSError`` retries with jittered backoff, a parse or semantic error
    propagates at once. ``data.read`` is the ingest fault point, inside
    the attempt."""

    def _attempt():
        fault_point("data.read", path=path)
        return fn()

    return retry_transient(_attempt, site=site)


MAX_FOLDER_DEPTH = 3

INVALID_CONTENT_FORMAT_ERROR = (
    "First line '{line_snippet}...' of file '{file_name}' is not "
    "'{content_type}' format. Please ensure the file is in '{content_type}' format."
)

NO_LABEL_ERROR = (
    "Got input data without labels. Please check the input data set. "
    "If training job is running on multiple instances, please switch "
    "to using single instance if number of records in the data set "
    "is less than number of workers (16 * number of instance) in the cluster."
)

PARQUET_NEEDS_PYARROW_ERROR = (
    "parquet channels need the pyarrow package, which is not installed. Install "
    "pyarrow, or use csv, libsvm or recordio-protobuf."
)

# the strings pandas reads as a missing value by default
_CSV_NA = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])


# ---------------------------------------------------------------------------
# File discovery / staging
# ---------------------------------------------------------------------------


def _is_data_file(dir_path, file_name):
    if not os.path.isfile(os.path.join(dir_path, file_name)):
        return False
    if file_name.startswith(".") or file_name.startswith("_"):
        return False
    if ".cache" in file_name and ("dtrain" in file_name or "dval" in file_name):
        return False
    return True


def _link_tree(dest_dir, src, depth):
    if depth > MAX_FOLDER_DEPTH:
        raise exc.UserError("Folder depth exceed the limit: {}.".format(MAX_FOLDER_DEPTH))
    if os.path.isfile(src):
        link = os.path.join(dest_dir, os.path.basename(src) + str(hash(src)))
        os.symlink(src, link)
        return
    for entry in os.scandir(src):
        if entry.is_file():
            link = os.path.join(dest_dir, entry.name + str(hash(entry.path)))
            os.symlink(entry.path, link)
        elif entry.is_dir():
            _link_tree(dest_dir, entry.path, depth + 1)


def stage_input_files(data_path):
    """Flatten one or more channel paths into a fresh temporary directory of
    symlinks. Returns it, or None (with the directory removed) when no path
    exists."""
    staging_dir = tempfile.mkdtemp(prefix="sagemaker_xgboost_torch_input_")
    paths = data_path if isinstance(data_path, list) else [data_path]
    found_any = False
    for path in paths:
        if not os.path.exists(path):
            logger.info("File path %s does not exist!", path)
            continue
        found_any = True
        try:
            _link_tree(staging_dir, path, 1)
        except exc.UserError as e:
            if "Folder depth exceed" in str(e):
                logger.warning(
                    "The depth of folder %s exceeds the limit %d. Files in deeper sub dirs "
                    "won't be loaded. Please adjust the folder structure accordingly.",
                    path,
                    MAX_FOLDER_DEPTH,
                )
            else:
                raise
    if not found_any:
        shutil.rmtree(staging_dir, ignore_errors=True)
        return None
    return staging_dir


_SIDECAR_SUFFIXES = (".group", ".weight")


def _skip_empty_files(files, count=True):
    """Drop zero-byte files from a channel listing. The first skip in the
    process warns; with ``count`` every skipped file counts in
    ``ingest_files_empty_total`` (the validation pass does not count, so a
    file it skips and the reader's own listing skips again counts once)."""
    kept, empty = [], []
    for f in files:
        try:
            size = os.path.getsize(os.path.realpath(f))
        except OSError:
            size = -1  # unreadable: left to the reader's retry policy
        (empty if size == 0 else kept).append(f)
    if empty:
        if count:
            from ..telemetry.registry import REGISTRY

            REGISTRY.counter(
                "ingest_files_empty_total",
                "Zero-byte channel files skipped during ingest",
            ).inc(len(empty))
        warn_once(
            logger, "ingest.empty_files",
            "skipping %d zero-byte file(s) in the channel (first: %s); "
            "further empty files are counted in ingest_files_empty_total "
            "without logging",
            len(empty),
            os.path.basename(os.path.realpath(empty[0])),
        )
    return kept


def _list_data_files(path):
    if os.path.isfile(path):
        return _skip_empty_files([path])
    # staged link names carry a per-process hash suffix: sort by the link
    # target so that the row order is the same in every run
    files = sorted(
        (os.path.join(path, f) for f in os.listdir(path) if _is_data_file(path, f)),
        key=lambda f: (os.path.realpath(f), f),
    )
    # pair sidecars against the full listing, before empty files are
    # dropped, so that an empty data file still claims its companion
    all_files = list(files)
    files = _skip_empty_files(files)
    out = []
    for f in files:
        real = os.path.realpath(f)
        if any(real.endswith(s) for s in _SIDECAR_SUFFIXES):
            base = real
            for s in _SIDECAR_SUFFIXES:
                if base.endswith(s):
                    base = base[: -len(s)]
                    break
            if any(os.path.realpath(g) == base for g in all_files if g != f):
                continue
        out.append(f)
    return out


# ---------------------------------------------------------------------------
# Format validation (first-line sniffing)
# ---------------------------------------------------------------------------


def _sniff_csv_delimiter(sample_line):
    try:
        delimiter = csv_module.Sniffer().sniff(sample_line).delimiter
    except Exception as e:
        raise exc.UserError(
            "Could not determine delimiter on line {}:\n{}".format(sample_line[:50], e)
        )
    return delimiter


def _is_valid_libsvm_label(token):
    parts = token.split(":")
    if len(parts) > 2:
        return False
    for part in parts:
        try:
            float(part)
        except ValueError:
            return False
    return True


def _count_libsvm_features(line):
    """-1 if the line is not valid libsvm; else the number of idx:val pairs."""
    tokens = line.split()
    if not tokens or not _is_valid_libsvm_label(tokens[0]):
        return -1
    count = 0
    for token in tokens[1:]:
        if token.startswith("qid:"):
            continue
        halves = token.split(":")
        if len(halves) != 2:
            return -1
        count += 1
    return count


def _first_line(p):
    with open(p, "r", errors="ignore") as f:
        return f.readline()


def _read_text(p):
    with open(p, "r", errors="ignore") as f:
        return f.read()


def decode_text(raw):
    """Bytes of a text channel -> str exactly as ``_read_text`` reads the
    file (the locale's encoding, undecodable bytes dropped, universal
    newlines), so a byte range of a file parses as that part of the file."""
    return io.TextIOWrapper(io.BytesIO(raw), errors="ignore").read()


def _read_bytes(p):
    with open(p, "rb") as f:
        return f.read()


def _validate_libsvm_file(path):
    with open(path, "r", errors="ignore") as f:
        for line in f:
            n = _count_libsvm_features(line.rstrip("\n"))
            if n > 1:
                return
            if n < 0:
                raise exc.UserError(
                    INVALID_CONTENT_FORMAT_ERROR.format(
                        line_snippet=line[:50],
                        file_name=os.path.basename(path),
                        content_type="LIBSVM",
                    )
                )
    logger.warning(
        "File %s is not an invalid LIBSVM file but has no features. "
        "Accepting simple validation.",
        os.path.basename(path),
    )


def validate_data_file_path(data_path, content_type):
    parsed = ct.get_content_type(content_type)
    if not os.path.exists(data_path):
        raise exc.UserError("{} is not a valid path!".format(data_path))
    if os.path.isfile(data_path):
        files = [data_path]
    else:
        # the first leaf directory in sorted order, the same on every run
        leaf_dir = None
        for root, dirs, _files in os.walk(data_path):
            dirs.sort()
            if not dirs:
                leaf_dir = root
                break
        files = sorted(
            os.path.join(leaf_dir, f)
            for f in os.listdir(leaf_dir)
            if _is_data_file(leaf_dir, f)
        )
    files = _skip_empty_files(files, count=False)  # the reader's own listing counts them
    if parsed == ct.CSV:
        for f in files:
            _sniff_csv_delimiter(_first_line(f))
    elif parsed == ct.LIBSVM:
        for f in files:
            _validate_libsvm_file(f)
    # parquet / recordio: binary formats, validated at parse time


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------


def _channel_delimiter(files, site="reader.csv"):
    """The csv delimiter of the first file, checked against the first line
    of every other file (an un-sniffable line is left to the parser)."""
    delimiter = _sniff_csv_delimiter(
        _read_with_retries(lambda: _first_line(files[0]), files[0], site))
    for f in files[1:]:
        line = _read_with_retries(lambda f=f: _first_line(f), f, site)
        try:
            found = _sniff_csv_delimiter(line)
        except exc.UserError:
            continue
        if found != delimiter:
            raise exc.UserError(
                "CSV delimiter mismatch in channel: file '{}' uses {!r} but "
                "'{}' (the first file) uses {!r}. All files of one channel "
                "must share a delimiter.".format(
                    os.path.basename(os.path.realpath(f)),
                    found,
                    os.path.basename(os.path.realpath(files[0])),
                    delimiter,
                )
            )
    return delimiter


def _csv_value(field):
    field = field.strip().strip('"')
    if field in _CSV_NA:
        return np.nan
    return float(field)


def _parse_csv_rows(text, delimiter):
    """The general csv path: NA spellings, short rows padded with NaN."""
    rows, width = [], None
    for lineno, line in enumerate(text.split("\n"), 1):
        line = line.rstrip("\r")
        if not line.strip():
            continue
        fields = line.split(delimiter)
        if width is None:
            width = len(fields)
        elif len(fields) > width:
            raise ValueError(
                "Error tokenizing data. C error: Expected {} fields in line {}, "
                "saw {}".format(width, lineno, len(fields))
            )
        row = [_csv_value(v) for v in fields]
        rows.append(row + [np.nan] * (width - len(row)))
    if not rows:
        return np.empty((0, 0), np.float32)
    return np.asarray(rows, dtype=np.float32)


def _with_nan_for_empty_fields(text, d):
    """Write "nan" into every empty field (two passes of the replace cover a
    run of empty fields of any length)."""
    text = text.replace(d + d, d + "nan" + d).replace(d + d, d + "nan" + d)
    text = text.replace("\n" + d, "\nnan" + d).replace(d + "\n", d + "nan\n")
    if text.startswith(d):
        text = "nan" + text
    if text.endswith(d):
        text += "nan"
    return text


def parse_csv_text(text, delimiter):
    """csv text -> float32 [rows, cols]: numpy's C parser where every field
    is a number or empty, the general path otherwise. The whole-file reader
    and the streaming ingest's chunks (``data/streaming.py``) both parse
    here, so a value parses to the same float either way."""
    if not text.strip():
        return np.empty((0, 0), np.float32)
    try:
        return np.loadtxt(io.StringIO(_with_nan_for_empty_fields(text, delimiter)),
                          delimiter=delimiter, dtype=np.float32, ndmin=2, comments=None)
    except ValueError:
        return _parse_csv_rows(text, delimiter)


def _parse_csv_file(path, delimiter):
    """One csv file -> float32 [rows, cols] (``parse_csv_text``)."""
    return parse_csv_text(_read_text(path), delimiter)


def _read_csv_files(path, csv_weights=0):
    files = _list_data_files(path)
    if not files:
        return None
    delimiter = _channel_delimiter(files)
    frames = [_read_with_retries(lambda f=f: _parse_csv_file(f, delimiter), f, "reader.csv")
              for f in files]
    width = max(frame.shape[1] for frame in frames)
    data = np.concatenate(
        [
            frame if frame.shape[1] == width
            else np.pad(frame, ((0, 0), (0, width - frame.shape[1])), constant_values=np.nan)
            for frame in frames
        ],
        axis=0,
    )
    if data.shape[1] < 2:
        raise exc.UserError(
            "CSV data needs at least a label column and one feature column"
        )
    labels = data[:, 0]
    if csv_weights == 1:
        if data.shape[1] < 3:
            raise exc.UserError("csv_weights=1 requires a weight column after the label")
        return DataMatrix(data[:, 2:], labels=labels, weights=data[:, 1])
    return DataMatrix(data[:, 1:], labels=labels)


def parse_libsvm_text(text, num_col=None):
    """Tokenize libsvm text into (csr, labels, weights, qids).

    Accepts ``<label>(:<weight>) (qid:<q>) <idx>:<val> ...``. Indices are
    taken verbatim as 0-based column ids, matching xgboost's file parser.
    Uses the native C++ tokenizer (``data/native.py``) where it loads; the
    Python tokenizer below is the fallback and the behavioural spec.
    """
    try:
        parsed = native.parse_libsvm_native(text)
    except ValueError as e:
        raise exc.UserError(str(e), caused_by=e)
    if parsed is not None:
        native.count_route("parse_native")
        (values, indices, indptr), labels_arr, weights_arr, qids_arr = parsed
        n = len(labels_arr)
        if n == 0:
            return None
        width = num_col or (int(indices.max()) + 1 if len(indices) else 1)
        csr = sp.csr_matrix((values, indices, indptr), shape=(n, width))
        return csr, labels_arr, weights_arr, qids_arr
    native.count_route("parse_python")
    labels, weights, qids = [], [], []
    data, indices, indptr = [], [], [0]
    has_weights = has_qids = False
    for lineno, line in enumerate(text.splitlines()):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tokens = line.split()
        head = tokens[0].split(":")
        try:
            labels.append(float(head[0]))
            if len(head) == 2:
                weights.append(float(head[1]))
                has_weights = True
            else:
                weights.append(1.0)
            for token in tokens[1:]:
                key, _, value = token.partition(":")
                if key == "qid":
                    qids.append(int(value))
                    has_qids = True
                    continue
                indices.append(int(key))
                data.append(float(value))
        except ValueError as e:
            raise exc.UserError(
                "Malformed LIBSVM line {}: '{}'".format(lineno + 1, line[:50]), caused_by=e
            )
        indptr.append(len(indices))
    n = len(labels)
    if n == 0:
        return None
    width = num_col or (max(indices) + 1 if indices else 1)
    csr = sp.csr_matrix(
        (
            np.asarray(data, dtype=np.float32),
            np.asarray(indices, dtype=np.int64),
            np.asarray(indptr, dtype=np.int64),
        ),
        shape=(n, width),
    )
    return (
        csr,
        np.asarray(labels, dtype=np.float32),
        np.asarray(weights, dtype=np.float32) if has_weights else None,
        np.asarray(qids, dtype=np.int64) if has_qids else None,
    )


def _qids_to_groups(qids):
    """Contiguous qid runs -> group-size array (ranking objectives)."""
    if qids is None:
        return None
    change = np.flatnonzero(np.diff(qids)) + 1
    bounds = np.concatenate([[0], change, [len(qids)]])
    return np.diff(bounds).astype(np.int32)


def _companion_file(data_file, suffix):
    """xgboost-style sidecar file (train.libsvm.group / .weight): next to
    the staged link or next to its target."""
    for candidate in (data_file + suffix, os.path.realpath(data_file) + suffix):
        if os.path.exists(candidate):
            return candidate
    return None


def _read_libsvm_files(path):
    files = _list_data_files(path)
    if not files:
        return None
    parts, sidecar_groups, sidecar_weights = [], [], []
    for f in files:
        parsed = parse_libsvm_text(_read_with_retries(lambda f=f: _read_text(f), f, "reader.libsvm"))
        if parsed is not None:
            parts.append(parsed)
            gf = _companion_file(f, ".group")
            if gf:
                sidecar_groups.append(np.loadtxt(gf, dtype=np.int64).reshape(-1))
            wf = _companion_file(f, ".weight")
            if wf:
                sidecar_weights.append(np.loadtxt(wf, dtype=np.float32).reshape(-1))
    if not parts:
        return None
    width = max(p[0].shape[1] for p in parts)
    csr = sp.vstack(
        [sp.csr_matrix((p[0].data, p[0].indices, p[0].indptr), shape=(p[0].shape[0], width))
         for p in parts]
    ).tocsr()
    labels = np.concatenate([p[1] for p in parts])
    weights = (
        np.concatenate([p[2] if p[2] is not None else np.ones(p[0].shape[0], np.float32)
                        for p in parts])
        if any(p[2] is not None for p in parts)
        else None
    )
    qids = (
        np.concatenate([p[3] for p in parts]) if all(p[3] is not None for p in parts) else None
    )
    groups = _qids_to_groups(qids)
    if sidecar_groups and len(sidecar_groups) == len(parts):
        groups = np.concatenate(sidecar_groups).astype(np.int32)
    if weights is None and sidecar_weights and len(sidecar_weights) == len(parts):
        weights = np.concatenate(sidecar_weights)
    return DataMatrix(csr, labels=labels, weights=weights, groups=groups)


def _parquet_column(column):
    """One parquet column -> f32 numpy, with the values pandas'
    ``to_numpy(float32)`` gives: nulls NaN (an int column with nulls goes
    through f64, as pandas makes it f64), bools 0/1, f64 rounded to f32."""
    import pyarrow as pa

    if column.null_count:
        column = column.cast(pa.float64())
    return column.to_numpy(zero_copy_only=False).astype(np.float32)


def parquet_table_matrix(table):
    """A pyarrow table -> f32 [rows, columns] (``_parquet_column`` each):
    the whole-file reader's and the streaming ingest's conversion."""
    if not table.num_columns:
        return np.zeros((table.num_rows, 0), np.float32)
    return np.stack([_parquet_column(c) for c in table.columns], axis=1)


def import_parquet():
    """``pyarrow.parquet``, or the UserError naming pyarrow."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise exc.UserError(PARQUET_NEEDS_PYARROW_ERROR, caused_by=e)
    return pq


def _read_parquet_files(path):
    pq = import_parquet()
    files = _list_data_files(path)
    if not files:
        return None
    tables = [_read_with_retries(lambda f=f: pq.read_table(f), f, "reader.parquet")
              for f in files]
    data = np.concatenate([parquet_table_matrix(t) for t in tables], axis=0)
    return DataMatrix(data[:, 1:], labels=data[:, 0])


def _read_recordio_files(path):
    files = _list_data_files(path)
    if not files:
        return None
    bufs = [_read_with_retries(lambda f=f: _read_bytes(f), f, "reader.recordio")
            for f in files]
    features, labels = read_recordio_protobuf(b"".join(bufs))
    return DataMatrix(features, labels=labels)


def get_data_matrix(data_path, content_type, csv_weights=0, is_pipe=False):
    """Load a channel into a DataMatrix.

    Returns None when the path holds no data (the host sits out of training).
    Raises UserError when data exists but carries no labels.
    """
    if is_pipe:
        raise exc.UserError(
            "Pipe mode is no longer supported. Please use Fast File mode (default) "
            "instead. Set input_mode='File' in your SageMaker Estimator or TrainingInput."
        )
    parsed = ct.get_content_type(content_type)
    staged = stage_input_files(data_path)
    if staged is None:
        return None
    try:
        if parsed == ct.CSV:
            dmatrix = _read_csv_files(staged, csv_weights)
        elif parsed == ct.LIBSVM:
            dmatrix = _read_libsvm_files(staged)
        elif parsed == ct.PARQUET:
            dmatrix = _read_parquet_files(staged)
        else:
            dmatrix = _read_recordio_files(staged)
    except exc.UserError:
        raise
    except Exception as e:
        raise exc.UserError(
            "Failed to load {} data with exception:\n{}".format(parsed, e), caused_by=e
        )
    finally:
        shutil.rmtree(staged, ignore_errors=True)
    if dmatrix is not None and dmatrix.get_label().size == 0:
        raise exc.UserError(NO_LABEL_ERROR)
    if dmatrix is not None and not np.isfinite(dmatrix.get_label()).all():
        raise exc.UserError(
            "Input data contains non-finite labels (NaN/inf). Please check that the "
            "label column is present and numeric in every row."
        )
    return dmatrix


# ---------------------------------------------------------------------------
# Size / redundancy helpers
# ---------------------------------------------------------------------------


def get_size(data_path, is_pipe=False):
    if is_pipe and os.path.exists("{}_0".format(data_path)):
        return 1
    if not os.path.exists(data_path):
        logger.info("Path %s does not exist!", data_path)
        return 0
    if os.path.isfile(data_path):
        return os.path.getsize(data_path)
    total = 0
    for root, _dirs, files in os.walk(data_path):
        for name in files:
            if name.startswith("."):
                raise exc.UserError(
                    "Hidden file found in the data path! Remove that before training."
                )
            total += os.path.getsize(os.path.join(root, name))
    return total


def check_data_redundancy(train_path, validate_path):
    if not os.path.exists(train_path):
        raise exc.UserError("training data's path is not existed")
    if not os.path.exists(validate_path):
        raise exc.UserError("validation data's path is not existed")
    train_files = {
        f for f in os.listdir(train_path) if os.path.isfile(os.path.join(train_path, f))
    }
    val_files = {
        f for f in os.listdir(validate_path) if os.path.isfile(os.path.join(validate_path, f))
    }
    for name in train_files & val_files:
        a = os.path.getsize(os.path.join(train_path, name))
        b = os.path.getsize(os.path.join(validate_path, name))
        if a == b:
            logger.warning(
                "Suspected identical files found. (%s and %s with same size %d bytes). "
                "Note: Duplicate data in the training set and validation set is usually "
                "not intentional and can impair the validity of the model evaluation by "
                "the validation score.",
                os.path.join(train_path, name),
                os.path.join(validate_path, name),
                b,
            )
