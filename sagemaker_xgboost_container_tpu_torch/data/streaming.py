"""Streaming (chunked) channel ingest: bounded-memory readers with a
rank-consistent skip/quarantine policy and a distributed sketch merge.

The port's counterpart of ``sagemaker_xgboost_container_tpu/data/streaming.py``.
The whole-file readers (``data/readers.py``) hold every channel file as
float32 on the host, and one corrupt file fails the whole job. This path
never holds the float channel:

* **Chunk planning.** Every channel file splits into deterministic chunks:
  newline-aligned byte ranges (csv, libsvm), record-aligned byte ranges
  (recordio-protobuf, by walking the 8-byte record headers) or row-group
  ranges (parquet, from the file metadata). The plan is a function of the
  sorted, realpath-keyed listing and ``SM_INGEST_CHUNK_BYTES`` alone, so
  every host derives the same plan from the same bytes; with
  ``SM_INGEST_SHARD=1`` ranks take chunks round-robin from one replicated
  channel.
* **Two passes.** Pass 1 parses chunk by chunk into a per-feature summary
  sketch (distinct values and their summed weights, at most
  ``SM_INGEST_SKETCH_SIZE`` a feature) and drops the floats; pass 2 parses
  each chunk again and bins it with the agreed cuts through
  ``binning.device_apply`` on the session's device (the card on a CUDA
  session) into a preallocated uint8/uint16 host matrix. A channel whose
  cuts are given (validation, binned with the training channel's cuts) bins
  in pass 1 and is read once. Memory is O(chunk + sketch + binned rows).
* **The same cuts on every rank.** Across hosts the ranks' sketch
  summaries are allgathered over the ``Cluster.synchronize`` framing on
  ``SM_INGEST_PORT`` and merged in rank order, so every rank derives the
  same cuts. On one host the sketch is exact: for unit or integer row
  weights the cuts, the binned matrix and the trees are bitwise those of
  the whole-file readers (``binning.cuts_from_summaries`` states the
  float-weight caveat).
* **Retry, skip, quarantine.** Each chunk's read and parse runs under the
  transient-retry policy (``SM_IO_RETRY_*``, site ``ingest.chunk``) behind
  the ``data.chunk`` fault point. A chunk that still fails is handled as
  ``SM_INGEST_BAD_CHUNK_ACTION`` says: ``fail`` (default) or ``skip``
  within ``SM_INGEST_MAX_BAD_CHUNKS``. The skip set is agreed across ranks
  by the same allgather, before any binning, and every skipped chunk lands
  in the quarantine record that ``train_job`` stamps into the model's
  manifest and ``ingest-quarantine.json``.
* **Failing loudly, on every rank.** A bad chunk under ``fail``, an
  exhausted skip budget, a plan divergence between ranks or a chunk that
  changed between the passes raises :class:`IngestError`; the training
  wiring turns it into ``EXIT_INGEST_FAILED`` (85) with a flight-recorder
  dump, on every rank, each having reached the verdict from the same
  allgathered state.
"""

import base64
import hashlib
import json
import logging
import os
import shutil
import struct
import threading

import numpy as np
import torch

from ..constants import EXIT_INGEST_FAILED
from ..telemetry.emit import emit_metric
from ..telemetry.registry import REGISTRY
from ..telemetry.tracing import trace_span
from ..toolkit import exceptions as exc
from ..utils.envconfig import env_bool, env_float, env_int, env_port
from ..utils.faults import fault_point
from ..utils.retry import retry_transient
from ..utils.warn_once import warn_once
from . import content_types as ct
from . import readers
from .binning import BinnedMatrix, cuts_from_summaries, device_apply, pad_cut_points
from .matrix import _densify_with_nan
from .recordio import RECORDIO_MAGIC, read_recordio_protobuf

logger = logging.getLogger(__name__)

INGEST_MODE_ENV = "SM_INGEST_MODE"
INGEST_CHUNK_BYTES_ENV = "SM_INGEST_CHUNK_BYTES"
INGEST_ACTION_ENV = "SM_INGEST_BAD_CHUNK_ACTION"
INGEST_MAX_BAD_ENV = "SM_INGEST_MAX_BAD_CHUNKS"
INGEST_SHARD_ENV = "SM_INGEST_SHARD"
INGEST_SKETCH_SIZE_ENV = "SM_INGEST_SKETCH_SIZE"
INGEST_WIRE_SKETCH_ENV = "SM_INGEST_WIRE_SKETCH"
INGEST_PORT_ENV = "SM_INGEST_PORT"
INGEST_TIMEOUT_ENV = "SM_INGEST_TIMEOUT_S"

# not the rendezvous (9099), heartbeat (9199) or abort (9299) ports: the
# sketch and skip allgather runs before any of those planes exist
DEFAULT_INGEST_PORT = 9599

# one frame bound for the ingest allgather on every rank (synchronize's
# contract): payload sizes differ by rank, so a bound taken from one's own
# payload would let a small-payload rank refuse a peer's large frame. 1 GiB
# caps a garbage length prefix; the receive stays deadlined
_INGEST_FRAME_CAP = 1 << 30


class IngestError(RuntimeError):
    """A chunked-ingest failure every rank reaches identically.

    ``reason`` is one of ``bad_chunk``, ``budget_exceeded``,
    ``plan_failed``, ``plan_divergence``, ``exchange_failed`` and
    ``chunk_drift``; the training wiring turns any IngestError into
    ``EXIT_INGEST_FAILED`` (85) with a flight-recorder dump.
    """

    def __init__(self, reason, message, **details):
        super().__init__(message)
        self.reason = reason
        self.details = details


class ChannelSemanticError(exc.UserError):
    """A problem of the whole channel that a chunk parser sees (a column
    count that ``csv_weights`` cannot split, no feature column): every
    chunk fails the same way, so quarantining it as corrupt bytes would
    spend the skip budget (or exit 85) on a data-format error. The
    bad-chunk ladder re-raises it as the whole-file readers' ``UserError``;
    a parse error of malformed bytes stays quarantinable."""


def channel_has_sidecars(content_type, *paths):
    """True when libsvm ``.weight`` / ``.group`` companion files exist under
    any of ``paths``. Only the whole-file readers honor them (a file's row
    spans do not map onto byte-range chunks), so they pin the whole-file
    path: ``auto`` falls back, a forced ``chunked`` refuses."""
    if ct.get_content_type(content_type) != ct.LIBSVM:
        return False
    for path in paths:
        if not path:
            continue
        if os.path.isfile(path):
            if any(os.path.isfile(path + s) for s in readers._SIDECAR_SUFFIXES):
                return True
            continue
        for _root, _dirs, names in os.walk(path):
            if any(n.endswith(readers._SIDECAR_SUFFIXES) for n in names):
                return True
    return False


class IngestConfig:
    """One snapshot of every SM_INGEST_* knob, resolved per channel ingest
    (a malformed value warns once and takes the default)."""

    def __init__(self):
        mode = os.environ.get(INGEST_MODE_ENV, "auto")
        if mode not in ("auto", "whole", "chunked"):
            warn_once(logger, "ingest.mode", "%s=%r is not auto|whole|chunked; using auto",
                      INGEST_MODE_ENV, mode)
            mode = "auto"
        action = os.environ.get(INGEST_ACTION_ENV, "fail")
        if action not in ("fail", "skip"):
            warn_once(logger, "ingest.action", "%s=%r is not fail|skip; using fail",
                      INGEST_ACTION_ENV, action)
            action = "fail"
        self.mode = mode
        self.action = action
        self.chunk_bytes = env_int(INGEST_CHUNK_BYTES_ENV, 64 * 1024 * 1024, minimum=4096)
        self.max_bad = env_int(INGEST_MAX_BAD_ENV, 8, minimum=0)
        self.shard = env_bool(INGEST_SHARD_ENV, False)
        self.sketch_size = env_int(INGEST_SKETCH_SIZE_ENV, 1 << 17, minimum=256)
        self.wire_sketch = env_int(INGEST_WIRE_SKETCH_ENV, 512, minimum=64)
        self.port = env_port(INGEST_PORT_ENV, DEFAULT_INGEST_PORT)
        self.timeout_s = env_float(INGEST_TIMEOUT_ENV, 300.0, minimum=1.0)


def resolve_ingest_config():
    return IngestConfig()


def supports_streaming(train_cfg):
    """-> (ok, reason, max_bin) for this training config.

    ``max_bin`` is resolved as ``models/booster.TrainConfig`` resolves it
    (the session checks the pre-binned matrix against its own reading, so
    a drift fails loudly). Chunked ingest needs the binned training path:
    gblinear fits the raw floats, ``process_type=update`` revisits committed
    trees, ``tree_method=exact`` bins at every distinct value and the approx
    re-sketch needs the float channel resident.
    """
    p = train_cfg or {}
    booster = p.get("booster", "gbtree")
    if booster not in ("gbtree",):
        return False, "booster={} trains on float features".format(booster), None
    if p.get("process_type", "default") != "default":
        return False, "process_type=update revisits committed trees", None
    tree_method = p.get("tree_method", "auto")
    if tree_method == "exact":
        return False, "tree_method=exact is unbounded-bin", None
    if tree_method == "approx":
        return False, "tree_method=approx re-sketches from float features", None
    if p.get("max_bin") is not None:
        max_bin = int(p["max_bin"])
    elif p.get("sketch_eps"):
        max_bin = int(min(max(1.0 / float(p["sketch_eps"]), 2), 1024))
    else:
        max_bin = 256
    return True, None, max_bin


# ---------------------------------------------------------------------------
# Chunk planning
# ---------------------------------------------------------------------------


class Chunk:
    """One deterministic unit of channel ingest.

    ``unit`` is ``bytes`` (a newline- or record-aligned ``[start, end)``
    byte range), ``rowgroups`` (a parquet row-group range) or ``file`` (the
    whole file, where a binary file's metadata cannot be walked: its parse
    error then lands where the skip policy can quarantine it).
    """

    __slots__ = ("file", "start", "end", "index", "unit", "size")

    def __init__(self, file, start, end, index, unit, size):
        self.file = file
        self.start = start
        self.end = end
        self.index = index
        self.unit = unit
        self.size = int(size)

    def describe(self):
        return {
            "file": self.file,
            "start": int(self.start),
            "end": int(self.end),
            "unit": self.unit,
            "index": int(self.index),
            # a byte size for every unit (row-group and whole-file chunks
            # carry the metadata's estimate), so skipped bytes never read 0
            "size": int(self.size),
        }


class ChunkPlan:
    def __init__(self, fmt, chunks, delimiter=None):
        self.fmt = fmt
        self.chunks = chunks
        self.delimiter = delimiter

    def fingerprint(self):
        doc = json.dumps(
            [[c.file, int(c.start), int(c.end), c.unit] for c in self.chunks], sort_keys=True)
        return hashlib.sha256(doc.encode()).hexdigest()


def _newline_ranges(path, size, chunk_bytes):
    """Newline-aligned byte ranges covering ``[0, size)``."""
    if size <= chunk_bytes:
        return [(0, size)]
    bounds = [0]
    with open(path, "rb") as f:
        target = chunk_bytes
        while target < size:
            f.seek(target)
            f.readline()  # finish the line the target landed inside
            pos = f.tell()
            if pos >= size:
                break
            bounds.append(pos)
            target = pos + chunk_bytes
    bounds.append(size)
    return list(zip(bounds[:-1], bounds[1:]))


def _recordio_ranges(path, size, chunk_bytes):
    """Record-aligned byte ranges, walking the 8-byte record headers (the
    payloads are seeked past). A corrupt header stops the walk and the rest
    of the file becomes one last chunk, so the corruption is met at parse
    time, inside a chunk the skip policy can quarantine."""
    if size <= chunk_bytes:
        return [(0, size)]
    bounds = [0]
    try:
        with open(path, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                magic, length = struct.unpack("<II", header)
                if magic != RECORDIO_MAGIC:
                    break
                f.seek((length + 3) & ~3, 1)
                pos = f.tell()
                if pos >= size:
                    break
                if pos - bounds[-1] >= chunk_bytes:
                    bounds.append(pos)
    except OSError:
        return [(0, size)]
    bounds.append(size)
    return [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def _parquet_rowgroup_ranges(path, chunk_bytes):
    """-> [(rg_start, rg_end)] row-group ranges, or None for the whole-file
    chunk (unreadable metadata)."""
    pq = readers.import_parquet()
    try:
        meta = pq.ParquetFile(path).metadata
    except Exception:
        return None
    if meta.num_row_groups == 0:
        # an empty part (a writer opened and closed with no table, common
        # from Spark): no chunks, as the whole-file reader reads 0 rows
        return []
    if meta.num_row_groups == 1:
        return [(0, 1)]
    ranges = []
    lo, acc = 0, 0
    for rg in range(meta.num_row_groups):
        acc += max(0, meta.row_group(rg).total_byte_size)
        if acc >= chunk_bytes and rg + 1 < meta.num_row_groups:
            ranges.append((lo, rg + 1))
            lo, acc = rg + 1, 0
    ranges.append((lo, meta.num_row_groups))
    return ranges


def plan_channel(files, fmt, chunk_bytes):
    """files (a channel listing) -> ChunkPlan with globally indexed chunks.

    A chunk is named by its file's realpath: the staged link names carry a
    per-process hash, the target is what every host and every rerun agree
    on.
    """
    delimiter = None
    if fmt == ct.CSV and files:
        try:
            delimiter = readers._channel_delimiter(files, site="ingest.plan")
        except OSError as e:
            # a persistent IO failure lands in the exit-85 plane like the
            # per-file planning below, never as a raw OSError
            raise IngestError(
                "plan_failed",
                "chunk planning failed sniffing the channel delimiter ({}); no plan "
                "can be agreed".format(e),
            )
    chunks = []
    for f in files:
        real = os.path.realpath(f)

        def _file_ranges():
            size = os.path.getsize(real)
            if fmt in (ct.CSV, ct.LIBSVM):
                return [(s, e, "bytes", e - s) for s, e in _newline_ranges(real, size, chunk_bytes)]
            if fmt == ct.PARQUET:
                rgs = _parquet_rowgroup_ranges(real, chunk_bytes)
                if rgs is None:
                    return [(0, size, "file", size)]
                share = size // max(1, len(rgs))
                return [(a, b, "rowgroups", share) for a, b in rgs]
            return [(s, e, "bytes", e - s) for s, e in _recordio_ranges(real, size, chunk_bytes)]

        try:
            # the chunk reads' transient-retry policy: a planning IO blip
            # must not escape as a raw OSError (no dump, no exit 85, peers
            # waiting in the allgather)
            ranges = retry_transient(_file_ranges, site="ingest.plan")
        except OSError as e:
            raise IngestError(
                "plan_failed",
                "chunk planning failed reading {} ({}); no plan can be agreed".format(real, e),
            )
        for start, end, unit, nbytes in ranges:
            chunks.append(Chunk(real, start, end, len(chunks), unit, nbytes))
    return ChunkPlan(fmt, chunks, delimiter=delimiter)


# ---------------------------------------------------------------------------
# Chunk parsing (both passes)
# ---------------------------------------------------------------------------


class _ChunkData:
    __slots__ = ("features", "labels", "weights", "qids")

    def __init__(self, features, labels, weights=None, qids=None):
        self.features = features  # float32 [rows, local width], NaN = missing
        self.labels = labels      # float32 [rows], or None (recordio without labels)
        self.weights = weights    # float32 [rows] or None
        self.qids = qids          # int64 [rows] or None


def _empty_chunk():
    return _ChunkData(np.empty((0, 0), np.float32), np.empty(0, np.float32))


def _read_range(path, start, end):
    with open(path, "rb") as f:
        f.seek(start)
        return f.read(end - start)


def _parse_csv_chunk(raw, delimiter, csv_weights):
    """A csv byte range through the whole-file reader's own parse
    (``readers.parse_csv_text``), so a field parses to the same f32."""
    data = readers.parse_csv_text(readers.decode_text(raw), delimiter)
    if data.shape[0] == 0:
        return _empty_chunk()
    if data.shape[1] < (3 if csv_weights == 1 else 2):
        raise ChannelSemanticError(
            "csv_weights=1 requires a weight column after the label"
            if csv_weights == 1
            else "CSV data needs at least a label column and one feature column"
        )
    labels = data[:, 0]
    if csv_weights == 1:
        return _ChunkData(data[:, 2:], labels, weights=data[:, 1])
    return _ChunkData(data[:, 1:], labels)


def _parse_libsvm_chunk(raw):
    parsed = readers.parse_libsvm_text(readers.decode_text(raw))
    if parsed is None:
        return _empty_chunk()
    csr, labels, weights, qids = parsed
    return _ChunkData(_densify_with_nan(csr), labels, weights=weights, qids=qids)


def _parse_parquet_chunk(chunk):
    pq = readers.import_parquet()
    if chunk.unit == "file":
        table = pq.read_table(chunk.file)
    else:
        table = pq.ParquetFile(chunk.file).read_row_groups(list(range(chunk.start, chunk.end)))
    data = readers.parquet_table_matrix(table)
    if data.size and data.shape[1] < 2:
        raise ChannelSemanticError(
            "Parquet data needs at least a label column and one feature column")
    if data.shape[0] == 0:
        return _empty_chunk()
    return _ChunkData(data[:, 1:], data[:, 0])


def _parse_recordio_chunk(raw):
    import scipy.sparse as sp

    features, labels = read_recordio_protobuf(raw)
    if sp.issparse(features):
        features = _densify_with_nan(features.tocsr())
    features = np.asarray(features, np.float32)
    if features.ndim != 2:
        features = features.reshape(len(features), -1)
    return _ChunkData(features, None if labels is None else np.asarray(labels, np.float32))


def _parse_chunk(plan, chunk, csv_weights):
    if plan.fmt == ct.PARQUET:
        return _parse_parquet_chunk(chunk)
    raw = _read_range(chunk.file, chunk.start, chunk.end)
    if plan.fmt == ct.CSV:
        return _parse_csv_chunk(raw, plan.delimiter, csv_weights)
    if plan.fmt == ct.LIBSVM:
        return _parse_libsvm_chunk(raw)
    return _parse_recordio_chunk(raw)


def _load_chunk(plan, chunk, csv_weights):
    """One chunk's read and parse under the transient-retry policy, behind
    the ``data.chunk`` fault point."""

    def _attempt():
        fault_point("data.chunk", path=chunk.file, start=chunk.start, end=chunk.end,
                    index=chunk.index)
        return _parse_chunk(plan, chunk, csv_weights)

    return retry_transient(_attempt, site="ingest.chunk")


class _ChunkBinner:
    """Bins chunks with one set of cuts through ``binning.device_apply`` on
    ``device`` (the session's; the card on a CUDA session): the cuts are
    padded onto the device once, each chunk's floats go up and its bins
    come back to the host matrix."""

    def __init__(self, cuts, max_bin, device):
        self.device = device
        self.max_bin = max_bin
        self.width = len(cuts)
        self.mids, self.n_cuts = pad_cut_points(cuts, device)

    def __call__(self, feats):
        x = torch.as_tensor(np.ascontiguousarray(feats, np.float32), device=self.device)
        return device_apply(x, self.mids, self.n_cuts, self.max_bin).cpu().numpy()


# ---------------------------------------------------------------------------
# Summary sketch (distinct values + summed weights, per feature)
# ---------------------------------------------------------------------------


def _dedup_sorted(v, w):
    """Sorted (values, weights) -> distinct values and their weight sums:
    ``np.unique(v, return_index=True)`` + ``reduceat`` on sorted input, in
    linear time (np.unique sorts again)."""
    if len(v) == 0:
        return v.astype(np.float32), w
    keep = np.empty(len(v), bool)
    keep[0] = True
    np.not_equal(v[1:], v[:-1], out=keep[1:])
    start = np.flatnonzero(keep)
    return v[start].astype(np.float32), np.add.reduceat(w, start)


def _merge_summary(a, b):
    """Two (values, weights) summaries -> the union of the values with
    summed weights. The stable argsort of two concatenated sorted runs is
    effectively linear, and it sums the weights in the order the
    whole-file path's cumulative sum sees them."""
    v = np.concatenate([a[0], b[0]])
    w = np.concatenate([a[1], b[1]])
    order = np.argsort(v, kind="stable")
    return _dedup_sorted(v[order], w[order])


def _compress_summary(values, weights, cap):
    """A summary capped at ``cap`` entries, a hard bound: the extremes and
    ``cap - 2`` evenly spaced cumulative-weight picks are kept, and each
    dropped entry's weight folds into the next kept one, so the total and
    the cumulative curve the cut selection reads are kept. The identity
    under the cap, which is where the whole-file bitwise equality holds."""
    n = len(values)
    if n <= cap:
        return values, weights
    cum = np.concatenate([[0.0], np.cumsum(weights, dtype=np.float64)])
    if cap <= 2:
        picks = np.unique(np.array([0, n - 1]))
    else:
        targets = cum[-1] * (np.arange(1, cap - 1, dtype=np.float64) / (cap - 1))
        interior = np.clip(np.searchsorted(cum[1:], targets, side="left"), 0, n - 1)
        picks = np.unique(np.concatenate([[0, n - 1], interior]))
    new_w = np.diff(cum[picks + 1], prepend=0.0)
    return values[picks], new_w


class SummarySketch:
    """Per-feature streaming summary: (distinct f32 values, f64 weight sums).

    Exact, and through ``cuts_from_summaries`` bitwise faithful to the
    whole-file path, while a feature has at most ``cap`` distinct values;
    past that the summary compresses deterministically, with one warning.
    """

    def __init__(self, cap):
        self.cap = cap
        self.cols = {}

    def update(self, features, row_weights):
        n, d = features.shape
        if n == 0:
            return
        w_rows = (np.ones(n, np.float64) if row_weights is None
                  else np.asarray(row_weights, np.float64))
        for f in range(d):
            col = features[:, f]
            mask = ~np.isnan(col)
            if not mask.any():
                continue
            v = col[mask]
            w = w_rows[mask]
            order = np.argsort(v, kind="stable")
            summary = _dedup_sorted(v[order], w[order])
            cur = self.cols.get(f)
            if cur is not None:
                summary = _merge_summary(cur, summary)
            if len(summary[0]) > self.cap:
                warn_once(
                    logger, "ingest.sketch_cap",
                    "ingest sketch exceeded %s=%d distinct values for a feature; "
                    "compressing (cuts stay rank-consistent but are no longer bitwise "
                    "whole-path identical)", INGEST_SKETCH_SIZE_ENV, self.cap,
                )
                summary = _compress_summary(summary[0], summary[1], self.cap)
            self.cols[f] = summary

    def summaries(self, width):
        empty = (np.empty(0, np.float32), np.empty(0, np.float64))
        return [self.cols.get(f, empty) for f in range(width)]

    def encode(self, width, wire_cap):
        """The wire form: each feature's summary capped at ``wire_cap``,
        values f32 and weights f64, base64."""
        values, weights = [], []
        for v, w in self.summaries(width):
            v, w = _compress_summary(v, w, wire_cap)
            values.append(base64.b64encode(np.asarray(v, np.float32).tobytes()).decode("ascii"))
            weights.append(base64.b64encode(np.asarray(w, np.float64).tobytes()).decode("ascii"))
        return {"width": width, "values": values, "weights": weights}

    @staticmethod
    def decode_summaries(doc):
        return [
            (np.frombuffer(base64.b64decode(vb), np.float32),
             np.frombuffer(base64.b64decode(wb), np.float64))
            for vb, wb in zip(doc["values"], doc["weights"])
        ]


# ---------------------------------------------------------------------------
# Quarantine bookkeeping (job-wide, stamped into the model manifest)
# ---------------------------------------------------------------------------

_state_lock = threading.Lock()
_skipped_chunks = []     # the agreed union across ranks and channels
_rows_skipped = 0
_bytes_skipped = 0
_bad_total = 0           # counts toward the budget across channels


def reset_ingest_state():
    """Clear the job's quarantine record and skip budget: at the start of
    every streaming ingest of a job (``get_validated_data_matrices``) and in
    tests, so that a second job in one process starts with the whole budget
    and an empty record."""
    global _rows_skipped, _bytes_skipped, _bad_total
    with _state_lock:
        del _skipped_chunks[:]
        _rows_skipped = 0
        _bytes_skipped = 0
        _bad_total = 0


def quarantine_record():
    """-> the job's quarantine manifest dict, or None when nothing was
    skipped: ``action``, ``max_bad_chunks``, ``chunks_skipped``,
    ``rows_skipped`` (rows known only where the bad chunk's bytes could be
    counted), ``bytes_skipped`` and ``skipped_chunks`` (one entry a chunk:
    file/start/end/unit/index/size/channel/rank/error/rows)."""
    with _state_lock:
        if not _skipped_chunks:
            return None
        cfg = resolve_ingest_config()
        return {
            "action": cfg.action,
            "max_bad_chunks": cfg.max_bad,
            "chunks_skipped": len(_skipped_chunks),
            "rows_skipped": int(_rows_skipped),
            "bytes_skipped": int(_bytes_skipped),
            "skipped_chunks": [dict(c) for c in _skipped_chunks],
        }


def write_quarantine_manifest(directory):
    """Write ``ingest-quarantine.json`` under ``directory`` (beside the
    model, so it travels in model.tar.gz). -> its path, or None when the
    job skipped nothing."""
    record = quarantine_record()
    if record is None:
        return None
    path = os.path.join(directory, "ingest-quarantine.json")
    tmp = os.path.join(directory, ".ingest-quarantine.json.tmp")
    with open(tmp, "w") as f:
        json.dump(record, f, sort_keys=True, indent=2)
    os.replace(tmp, path)
    return path


def abort_on_ingest_failure(err):
    """An IngestError -> the exit-85 abort: one ``training.abort`` record,
    the flight-recorder dump, then ``EXIT_INGEST_FAILED``, through the
    watchdog's ``request_abort``. Every rank that reached the allgathered
    verdict calls it with the same state."""
    from ..training import watchdog

    record = quarantine_record() or {}
    watchdog.request_abort(
        "ingest_failed",
        EXIT_INGEST_FAILED,
        ingest_reason=getattr(err, "reason", "unknown"),
        detail=str(err),
        chunks_skipped=record.get("chunks_skipped", 0),
    )


# ---------------------------------------------------------------------------
# The ingest pipeline
# ---------------------------------------------------------------------------


def _chunks_counter(status):
    return REGISTRY.counter(
        "ingest_chunks_total", "Channel chunks ingested by the streaming reader",
        {"status": status})


def _bytes_counter(status):
    return REGISTRY.counter(
        "ingest_bytes_total", "Channel bytes ingested (ok) or quarantined (skipped)",
        {"status": status})


def _rows_skipped_counter():
    return REGISTRY.counter(
        "ingest_rows_skipped_total", "Rows lost to quarantined chunks (best-effort row counts)")


class _Pass1State:
    def __init__(self):
        self.rows = {}        # chunk index -> parsed row count
        self.ncol = 0         # feature width (labels and weights split off)
        self.bad = []         # [{chunk fields..., error, rows}]
        self.failed = None    # the fail-policy error string
        self.missing_labels = False
        self.has_qids = False  # a non-empty chunk carried libsvm qid:
        self.blocks = {}      # chunk index -> its bins, where the cuts were given


def _estimate_rows(chunk, fmt):
    """Best-effort row count of a bad text chunk (its newlines)."""
    if fmt not in (ct.CSV, ct.LIBSVM) or chunk.unit != "bytes":
        return 0
    try:
        return _read_range(chunk.file, chunk.start, chunk.end).count(b"\n")
    except Exception:
        return 0


def _pad_to_width(feats, width):
    """A narrower chunk (libsvm's local width, a csv chunk of short rows):
    all-missing columns on the right, as the whole-file readers pad."""
    if feats.shape[1] >= width:
        return feats
    pad = np.full((feats.shape[0], width - feats.shape[1]), np.nan, np.float32)
    return np.concatenate([feats, pad], axis=1)


def _chunk_span(chunk, pass_, channel):
    return trace_span("data.chunk", attributes={
        "pass": pass_, "file": os.path.basename(chunk.file), "start": chunk.start,
        "end": chunk.end, "index": chunk.index, "channel": channel})


def _pass1(plan, assigned, cfg, sketch, csv_weights, rank, channel, binner=None):
    state = _Pass1State()
    for chunk in assigned:
        with _chunk_span(chunk, 1, channel):
            try:
                data = _load_chunk(plan, chunk, csv_weights)
            except (KeyboardInterrupt, SystemExit, ChannelSemanticError):
                raise
            except Exception as e:
                entry = dict(chunk.describe(), channel=channel, rank=rank,
                             error="{}: {}".format(type(e).__name__, e),
                             rows=_estimate_rows(chunk, plan.fmt))
                state.bad.append(entry)
                if cfg.action == "fail":
                    # name the chunk: this is the detail of the exit-85
                    # training.abort record
                    state.failed = "{}[{}:{}) {}".format(
                        os.path.basename(chunk.file), chunk.start, chunk.end, entry["error"])
                    logger.error("bad chunk %s[%s:%s) under %s=fail: %s",
                                 os.path.basename(chunk.file), chunk.start, chunk.end,
                                 INGEST_ACTION_ENV, e)
                    break
                logger.warning(
                    "bad chunk %s[%s:%s): %s - marked for the cross-rank skip agreement "
                    "(%d bad so far on this rank)", os.path.basename(chunk.file),
                    chunk.start, chunk.end, e, len(state.bad))
                if len(state.bad) > cfg.max_bad:
                    break  # the verdict can only be worse; stop reading
                continue
        state.rows[chunk.index] = data.features.shape[0]
        state.ncol = max(state.ncol, data.features.shape[1])
        if data.qids is not None and data.features.shape[0] > 0:
            state.has_qids = True
        if data.labels is None and data.features.shape[0] > 0:
            state.missing_labels = True
        if sketch is not None:
            sketch.update(data.features, data.weights)
        elif binner is not None and data.features.shape[1] <= binner.width:
            # the cuts are given (validation): bin now and drop the floats,
            # so the channel is read once. A chunk wider than the cuts gets
            # no block; that job raises the wider-than-training UserError
            state.blocks[chunk.index] = (
                binner(_pad_to_width(data.features, binner.width)),
                data.labels, data.weights, data.qids)
    return state


def _exchange_state(world, current_host, payload, cfg, master_addr=None):
    """One allgather of every rank's ingest state -> the payloads in rank
    order. Any transport failure is an IngestError: ingest cannot go on
    without agreed cuts and an agreed skip set."""
    if not world:
        return [payload]
    from ..parallel.distributed import Cluster

    cluster = Cluster(world, current_host, port=cfg.port)
    if master_addr is not None:
        cluster.master_host = master_addr
    try:
        return cluster.synchronize(payload, timeout=cfg.timeout_s,
                                   max_frame_bytes=_INGEST_FRAME_CAP)
    except Exception as e:
        raise IngestError(
            "exchange_failed",
            "ingest state allgather failed ({}); cuts and the skip set cannot be agreed - "
            "aborting rather than training on potentially misaligned shards".format(e),
        )


def _verdict(replies, cfg, channel, rank=0):
    """The rank-identical part: the skip set's union, the budget, the plan
    check. Every rank evaluates it over the same replies, so every rank
    raises or goes on alike. ``rank`` scopes the counters to this rank's
    own chunks (a sum over the fleet must not count a skip once a rank);
    the quarantine record keeps the agreed union."""
    global _rows_skipped, _bytes_skipped, _bad_total
    all_bad = [dict(b) for r in replies for b in r.get("bad", ())]
    failures = [r["failed"] for r in replies if r.get("failed")]
    plans = {r.get("plan") for r in replies if r.get("plan") is not None}
    if cfg.shard and len(plans) > 1:
        raise IngestError(
            "plan_divergence",
            "ranks derived different chunk plans for a sharded channel ({} distinct "
            "fingerprints) - the channel is not identical across hosts".format(len(plans)),
            fingerprints=sorted(plans),
        )
    if failures:
        raise IngestError(
            "bad_chunk",
            "unreadable chunk under {}=fail: {}".format(INGEST_ACTION_ENV, failures[0]),
            bad_chunks=all_bad,
        )
    with _state_lock:
        new_total = _bad_total + len(all_bad)
    if new_total > cfg.max_bad:
        first = all_bad[0] if all_bad else None
        raise IngestError(
            "budget_exceeded",
            "{} bad chunk(s) across ranks exceed {}={} - refusing to train on what "
            "remains{}".format(
                new_total, INGEST_MAX_BAD_ENV, cfg.max_bad,
                "" if first is None else " (first: {}[{}:{}) {})".format(
                    os.path.basename(first["file"]), first["start"], first["end"],
                    first["error"]),
            ),
            bad_chunks=all_bad,
        )
    if all_bad:
        def _chunk_bytes(b):
            return max(0, int(b.get("size", b["end"] - b["start"])))

        skipped_bytes = sum(_chunk_bytes(b) for b in all_bad)
        skipped_rows = sum(int(b.get("rows", 0)) for b in all_bad)
        with _state_lock:
            _bad_total = new_total
            _skipped_chunks.extend(all_bad)
            _rows_skipped += skipped_rows
            _bytes_skipped += skipped_bytes
        own = [b for b in all_bad if b.get("rank") == rank]
        _chunks_counter("skipped").inc(len(own))
        _bytes_counter("skipped").inc(sum(_chunk_bytes(b) for b in own))
        _rows_skipped_counter().inc(sum(int(b.get("rows", 0)) for b in own))
        emit_metric("ingest.quarantine", channel=channel, chunks_skipped=len(all_bad),
                    rows_skipped=skipped_rows, bytes_skipped=skipped_bytes,
                    budget=cfg.max_bad)
        logger.warning(
            "quarantined %d chunk(s) (~%d rows, %d bytes) in channel %r by cross-rank "
            "agreement; training proceeds without them", len(all_bad), skipped_rows,
            skipped_bytes, channel)
    return all_bad


class _MatrixAssembler:
    """The per-chunk accumulator of both binning paths (pass 2 and the pass-1
    blocks): the preallocated matrix, the lazy weights, the qid rule and the
    ok-chunk counters, in one place."""

    def __init__(self, n_total, width, max_bin):
        dtype = np.uint8 if max_bin + 1 <= 256 else np.uint16
        self.bins = np.empty((n_total, width), dtype)
        self.labels = np.empty(n_total, np.float32)
        self.weights = None
        self._n_total = n_total
        self._qids = []
        self._qids_ok = True
        self._offset = 0

    def add(self, chunk, block, labels, weights, qids):
        rows = block.shape[0]
        self.bins[self._offset:self._offset + rows] = block
        self.labels[self._offset:self._offset + rows] = np.nan if labels is None else labels
        if weights is not None:
            if self.weights is None:
                self.weights = np.ones(self._n_total, np.float32)
            self.weights[self._offset:self._offset + rows] = weights
        if qids is not None:
            self._qids.append(np.asarray(qids, np.int64))
        elif rows > 0:
            # only a chunk with rows breaks the channel's qid coverage: an
            # empty one (blank or comment lines) has no rows to group
            self._qids_ok = False
        self._offset += rows
        _chunks_counter("ok").inc()
        _bytes_counter("ok").inc(max(0, chunk.size))

    def finish(self):
        groups = None
        if self._qids_ok and self._qids:
            groups = readers._qids_to_groups(np.concatenate(self._qids))
        return self.bins, self.labels, self.weights, groups


def _pass2(plan, kept, state_rows, binner, csv_weights, channel):
    asm = _MatrixAssembler(sum(state_rows[c.index] for c in kept), binner.width,
                           binner.max_bin)
    for chunk in kept:
        with _chunk_span(chunk, 2, channel):
            try:
                data = _load_chunk(plan, chunk, csv_weights)
            except (KeyboardInterrupt, SystemExit, ChannelSemanticError):
                raise
            except Exception as e:
                raise IngestError(
                    "chunk_drift",
                    "chunk {}[{}:{}) failed on the binning pass after the skip set was "
                    "agreed ({}); re-agreeing is impossible without desharding the "
                    "cluster".format(os.path.basename(chunk.file), chunk.start, chunk.end, e),
                )
            rows = data.features.shape[0]
            if rows != state_rows[chunk.index]:
                raise IngestError(
                    "chunk_drift",
                    "chunk {}[{}:{}) changed between passes ({} rows, expected {})".format(
                        os.path.basename(chunk.file), chunk.start, chunk.end, rows,
                        state_rows[chunk.index]),
                )
            asm.add(chunk, binner(_pad_to_width(data.features, binner.width)),
                    data.labels, data.weights, data.qids)
    return asm.finish()


def _assemble_blocks(kept, state, width, max_bin):
    """The matrix from the blocks pass 1 binned (cuts given): a copy, not a
    second read. Blocks are dropped as they are copied."""
    asm = _MatrixAssembler(sum(state.rows[c.index] for c in kept), width, max_bin)
    for chunk in kept:
        asm.add(chunk, *state.blocks.pop(chunk.index))
    return asm.finish()


def ingest_channel(
    data_path,
    content_type,
    max_bin,
    channel="train",
    csv_weights=0,
    cut_points=None,
    hosts=None,
    current_host=None,
    master_addr=None,
    config=None,
    device=None,
):
    """Chunked ingest of one channel -> :class:`BinnedMatrix`, binned on
    ``device`` (CUDA unless given; raises without a GPU unless
    ``device="cpu"``).

    ``cut_points`` gives agreed cuts (a validation channel bins with the
    training channel's and sketches nothing); otherwise pass 1 builds the
    sketch and every rank derives the same cuts from the merged summaries.
    ``hosts`` / ``current_host`` arm the exchange across ranks (one host
    skips it); a host whose channel holds no data still takes part, with
    an empty payload, and gets None, so its peers never wait for its
    sketch.

    Raises :class:`IngestError` for every failure the cluster answers with
    exit 85, and the whole-file readers' ``UserError`` for semantic
    problems (no labels, non-finite labels, too few columns).
    """
    from .._device import resolve_device

    dev = resolve_device(device)
    cfg = config or resolve_ingest_config()
    fmt = ct.get_content_type(content_type)
    world = sorted(hosts) if hosts and len(hosts) > 1 else None
    rank = world.index(current_host) if world else 0

    sketch = SummarySketch(cfg.sketch_size) if cut_points is None else None
    plan = ChunkPlan(fmt, [])
    assigned = []
    state = _Pass1State()
    local_error = None
    binner = None if cut_points is None else _ChunkBinner(cut_points, max_bin, dev)
    try:
        staged = None
        try:
            # the readers' staging: a fresh directory of links a call,
            # needed only to list the files (chunks carry realpaths)
            staged = readers.stage_input_files(data_path)
            files = readers._list_data_files(staged) if staged is not None else []
            plan = plan_channel(files, fmt, cfg.chunk_bytes)
        except OSError as e:
            # staging and listing lie outside the ingest.plan retry site
            # but belong to the same exit-85 plane (and ride the error
            # broadcast below): a raw OSError would leave every peer in
            # the allgather for SM_INGEST_TIMEOUT_S
            raise IngestError(
                "plan_failed",
                "chunk planning failed staging/listing the channel ({}); no plan can be "
                "agreed".format(e),
            )
        finally:
            if staged is not None:
                shutil.rmtree(staged, ignore_errors=True)
        if world and cfg.shard:
            assigned = [c for c in plan.chunks if c.index % len(world) == rank]
        else:
            assigned = list(plan.chunks)
        logger.info(
            "chunked ingest of channel %r: %d file(s), %d chunk(s) planned, %d assigned to "
            "this rank (chunk_bytes=%d, action=%s)", channel, len(files), len(plan.chunks),
            len(assigned), cfg.chunk_bytes, cfg.action)
        state = _pass1(plan, assigned, cfg, sketch, csv_weights, rank, channel, binner=binner)
    except (exc.UserError, IngestError) as e:
        # a rank failing before the allgather (a delimiter mismatch, a
        # semantic parse error, a planning IO failure) still joins it:
        # leaving would strand every peer there and blame "exchange_failed".
        # The error rides the payload and every rank raises it below
        if world is None:
            raise
        local_error = {
            "kind": "ingest" if isinstance(e, IngestError) else "user",
            "reason": getattr(e, "reason", None),
            "message": str(e),
        }
        logger.error("local ingest failure on channel %r (broadcast to peers): %s", channel, e)

    payload = {
        "rank": rank,
        "channel": channel,
        "chunks": len(assigned),
        "rows": int(sum(state.rows.values())),
        "ncol": int(state.ncol),
        "bad": state.bad,
        "failed": state.failed,
        "plan": plan.fingerprint() if (world and cfg.shard and local_error is None) else None,
        "missing_labels": bool(state.missing_labels),
        "qids": bool(state.has_qids),
        "error": local_error,
    }
    if world and sketch is not None:
        payload["sketch"] = sketch.encode(state.ncol, cfg.wire_sketch)
    replies = _exchange_state(world, current_host, payload, cfg, master_addr)
    for r in replies:
        # the first local failure, in rank order, fails every rank alike
        err = r.get("error")
        if err:
            if err.get("kind") == "user":
                raise exc.UserError(err.get("message", "ingest failed"))
            raise IngestError(err.get("reason") or "plan_failed",
                              err.get("message", "ingest failed"))
    all_bad = _verdict(replies, cfg, channel, rank=rank)
    if world and cfg.shard and any(r.get("qids") for r in replies):
        # chunk round-robin would split query groups across ranks and
        # corrupt the ranking gradients
        raise exc.UserError(
            "SM_INGEST_SHARD=1 cannot preserve libsvm query groups (qid:): chunk "
            "round-robin fragments groups across ranks; disable sharding for ranking data."
        )

    width = max(int(r.get("ncol", 0)) for r in replies)
    total_rows = sum(int(r.get("rows", 0)) for r in replies)
    if total_rows == 0:
        return None  # an empty channel everywhere: the caller's "no data" path
    if width == 0:
        raise exc.UserError(
            "Channel {!r} parsed to zero feature columns; check the data format "
            "({}).".format(channel, fmt))
    if any(r.get("missing_labels") for r in replies):
        raise exc.UserError(readers.NO_LABEL_ERROR)

    if cut_points is None:
        if world:
            merged = SummarySketch(cfg.sketch_size)
            for r in replies:
                doc = r.get("sketch")
                if not doc:
                    continue
                for f, summary in enumerate(SummarySketch.decode_summaries(doc)):
                    if len(summary[0]) == 0:
                        continue
                    cur = merged.cols.get(f)
                    out = summary if cur is None else _merge_summary(cur, summary)
                    if len(out[0]) > cfg.sketch_size:
                        out = _compress_summary(out[0], out[1], cfg.sketch_size)
                    merged.cols[f] = out
            summaries = merged.summaries(width)
        else:
            summaries = sketch.summaries(width)
        cuts = cuts_from_summaries(summaries, max_bin)
    else:
        cuts = cut_points
        if len(cuts) < width:
            raise exc.UserError(
                "Channel {!r} has {} feature columns but the training channel binned only "
                "{} - validation data must not be wider than training data".format(
                    channel, width, len(cuts)))
        width = len(cuts)

    # the agreed-bad chunks this rank drops: under sharding every rank reads
    # one plan, so (file, start, end) names a chunk globally; with a channel
    # a host (ShardedByS3Key) two hosts may hold same-named paths with
    # different bytes, so only this rank's own entries apply
    skipped = {
        (b["file"], b["start"], b["end"])
        for b in all_bad
        if b.get("channel") == channel and (cfg.shard or b.get("rank") == rank)
    }
    kept = [c for c in assigned
            if c.index in state.rows and (c.file, int(c.start), int(c.end)) not in skipped]
    if binner is not None and all(c.index in state.blocks for c in kept):
        bins, labels, weights, groups = _assemble_blocks(kept, state, width, max_bin)
    else:
        bins, labels, weights, groups = _pass2(
            plan, kept, state.rows, _ChunkBinner(cuts, max_bin, dev), csv_weights, channel)
    if labels.size == 0:
        return None
    if not np.isfinite(labels).all():
        raise exc.UserError(
            "Input data contains non-finite labels (NaN/inf). Please check that the label "
            "column is present and numeric in every row."
        )
    return BinnedMatrix(bins, cuts, max_bin, labels=labels, weights=weights, groups=groups)
