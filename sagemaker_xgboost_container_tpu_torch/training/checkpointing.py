"""Spot-safe checkpointing: save/resume + retention with SageMaker markers.

The port's counterpart of ``sagemaker_xgboost_container_tpu/training/checkpointing.py``:

* checkpoints are full serialized models named ``xgboost-checkpoint.<iter>``
  in the checkpoint dir; resume picks the highest iteration whose file
  verifies (the sha256 of its ``.manifest`` sidecar where one exists, else
  a JSON parse; a corrupt, partial or tampered file is skipped with a
  warning) and training continues with ``num_round - iteration`` remaining
  rounds,
* writes are atomic (tempfile + rename), and drop any sidecar of the name
  they overwrite,
* a daemon thread deletes all but the ``max_to_keep`` newest, deferring any
  file SageMaker is mid-upload (``.sagemaker-uploading`` marker present and
  ``.sagemaker-uploaded`` absent),
* ``SaveIntermediateModelCallBack`` overwrites ``<model_dir>/<model_name>``
  every round so SIGTERM (spot interruption / HPO early stop) always leaves
  a fresh model behind,
* each checkpoint gets a manifest sidecar (``<name>.manifest``: sha256, byte
  count, iteration, the job's config fingerprint and, after an elastic
  shrink, the membership log (``training/elastic.py``)), written after the
  model with the same atomic, retried write; the intermediate model gets
  none (a SIGTERM between its two renames would leave a sidecar describing
  the previous round's bytes),
* transient ``OSError``s of a save or a manifest write retry
  (``utils/retry.py``), with the ``checkpoint.save`` and
  ``checkpoint.manifest`` fault points inside the attempts,
* ``flush_checkpoints`` and ``active_checkpoint_dirs`` (a weak registry of
  the live savers) serve the watchdog's abort path.

The manifest schema is the JAX package's, so each package resumes from the
other's checkpoints and verifies their digests.
"""

import json
import logging
import os
import queue
import re
import tempfile
import threading
import time
import weakref

from ..telemetry.tracing import trace_span
from ..utils import integrity
from ..utils.faults import fault_point
from ..utils.retry import retry_transient

TEMP_FILE_SUFFIX = ".sagemaker-ignore"
FILE_LOCK_SUFFIX = ".sagemaker-uploading"
FILE_SAFE_SUFFIX = ".sagemaker-uploaded"
MANIFEST_SUFFIX = integrity.MANIFEST_SUFFIX

CHECKPOINT_FILENAME = "xgboost-checkpoint"

logger = logging.getLogger(__name__)

# live SaveCheckpointCallBack instances, for the abort path's flush; weak, so
# a finished run's saver does not linger
_active_savers = weakref.WeakSet()


def _note_verify_fail(reason):
    from ..telemetry import REGISTRY

    REGISTRY.counter(
        "checkpoint_verify_fail_total",
        "Resume candidates rejected by digest or parse validation",
        {"reason": reason},
    ).inc()


def _checkpoint_usable(path):
    """A checkpoint is usable when it is non-empty and, with a manifest
    sidecar, its sha256 matches the manifest (a bit flip that keeps the
    JSON valid is caught only so), or, without one, it parses as JSON (a
    file cut off mid-write, or truncated, does not)."""
    try:
        if os.path.getsize(path) == 0:
            return False
    except OSError:
        return False
    manifest = integrity.read_manifest(path)
    if manifest is not None:
        try:
            integrity.verify_file_against_manifest(path, manifest)
            return True
        except integrity.IntegrityError as e:
            logger.warning("checkpoint digest verification failed: %s", e)
            _note_verify_fail("digest")
            return False
        except OSError:
            _note_verify_fail("io")
            return False
    try:
        with open(path, "rb") as f:
            json.loads(f.read().decode("utf-8"))
        return True
    except OSError:
        _note_verify_fail("io")
        return False
    except (ValueError, UnicodeDecodeError):
        _note_verify_fail("parse")
        return False


def load_checkpoint(checkpoint_dir):
    """-> (model path or None, next iteration number).

    Picks the highest-iteration checkpoint that verifies
    (``_checkpoint_usable``); a corrupt, partial or tampered file is skipped
    with a warning and the next-highest takes over. Also removes orphaned
    ``.sagemaker-ignore`` temp files of a crash in ``_atomic_save`` and
    orphaned ``.manifest`` sidecars whose checkpoint is gone.
    """
    if not checkpoint_dir or not os.path.exists(checkpoint_dir):
        return None, 0
    pattern = re.compile(r"^{}\.([0-9]+)$".format(re.escape(CHECKPOINT_FILENAME)))
    found = []
    names = set(os.listdir(checkpoint_dir))
    for name in sorted(names):
        if name.endswith(TEMP_FILE_SUFFIX):
            try:
                os.remove(os.path.join(checkpoint_dir, name))
                logger.info("removed orphaned checkpoint temp file %s", name)
            except OSError:
                logger.debug("could not remove orphaned temp file %s", name)
            continue
        if name.endswith(MANIFEST_SUFFIX):
            if name[: -len(MANIFEST_SUFFIX)] not in names:
                try:
                    os.remove(os.path.join(checkpoint_dir, name))
                    logger.info("removed orphaned checkpoint manifest %s", name)
                except OSError:
                    logger.debug("could not remove orphaned manifest %s", name)
            continue
        m = pattern.match(name)
        if m:
            found.append((int(m.group(1)), name))
    for iteration, name in sorted(found, reverse=True):
        path = os.path.join(checkpoint_dir, name)
        if _checkpoint_usable(path):
            return path, iteration + 1
        logger.warning(
            "checkpoint %s is corrupt or partial; falling back to the "
            "next-highest iteration", name
        )
    return None, 0


def _atomic_save(model, directory, final_name, iteration=None, fingerprint=None,
                 membership_log=None):
    """Save ``model`` to a temp file in ``directory`` and rename it to
    ``final_name``, retrying transient ``OSError``s; each attempt uses a
    fresh temp file and removes it when it fails. A sidecar of
    ``final_name`` is removed before the rename, so it never describes the
    new bytes.

    With ``iteration`` or ``fingerprint`` (a checkpoint), a manifest
    (sha256 and byte count of the temp file, taken before the rename, the
    iteration, the fingerprint and the membership log) is written after the
    model: a crash in
    between leaves a manifest-less checkpoint (the parse fallback), never a
    manifest of a file that is not there."""
    digest_box = {}
    want_manifest = iteration is not None or fingerprint is not None

    def _attempt():
        fault_point("checkpoint.save", path=final_name)
        with tempfile.NamedTemporaryFile(
            dir=directory, suffix=TEMP_FILE_SUFFIX, delete=False, mode="w"
        ) as tf:
            tmp = tf.name
        try:
            model.save_model(tmp)
            if want_manifest:
                digest_box["sha256"] = integrity.file_digest(tmp)
                digest_box["bytes"] = os.path.getsize(tmp)
            try:
                os.remove(os.path.join(directory, final_name + MANIFEST_SUFFIX))
            except OSError:
                pass
            os.rename(tmp, os.path.join(directory, final_name))
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    # with SM_TRACE the save and its manifest nest under the callback's
    # `checkpoint` phase in the round span: slow storage shows as a fat span
    with trace_span("checkpoint.save", attributes={"file": final_name}):
        retry_transient(_attempt, site="checkpoint.save")
    if not want_manifest:
        return
    manifest = integrity.build_manifest(
        os.path.join(directory, final_name),
        iteration=iteration,
        fingerprint=fingerprint,
        digest=digest_box["sha256"],
        size=digest_box["bytes"],
        membership_log=membership_log,
    )
    _atomic_write_manifest(directory, final_name + MANIFEST_SUFFIX, manifest)


def _atomic_write_manifest(directory, manifest_name, manifest):
    """The manifest sidecar: temp file + rename under ``retry_transient``,
    each attempt removing its own temp file, the durability of the model
    write it describes."""

    def _attempt():
        fault_point("checkpoint.manifest", path=manifest_name)
        with tempfile.NamedTemporaryFile(
            dir=directory, suffix=TEMP_FILE_SUFFIX, delete=False, mode="w"
        ) as tf:
            tmp = tf.name
        integrity.dump_manifest_atomic(os.path.join(directory, manifest_name), manifest, tmp)

    with trace_span("checkpoint.manifest", attributes={"file": manifest_name}):
        retry_transient(_attempt, site="checkpoint.manifest")


def active_checkpoint_dirs():
    """Checkpoint dirs of the live savers: where the abort path's
    flight-recorder and forensics dumps land when no trace dir is set (the
    platform uploads the checkpoint channel)."""
    return [s.checkpoint_dir for s in list(_active_savers) if s.checkpoint_dir]


def flush_checkpoints(timeout=10.0):
    """Abort-path flush: drain every live saver's deleter so the newest
    checkpoints are settled before the process exits (the saves themselves
    are synchronous). The join is bounded: a deleter wedged on the storage
    that caused the abort must not keep the process from its exit."""
    for saver in list(_active_savers):
        try:
            saver.stop(timeout=timeout)
        except Exception:
            logger.exception("checkpoint flush failed for %r", saver)


class SaveCheckpointCallBack:
    """Save a checkpoint each round; background-delete stale ones."""

    SENTINEL = None

    def __init__(self, checkpoint_dir, start_iteration=0, max_to_keep=5, num_round=None,
                 fingerprint=None, membership_provider=None):
        self.checkpoint_dir = checkpoint_dir
        self.max_to_keep = max_to_keep
        self.start_iteration = start_iteration
        self.num_round = num_round
        # the config fingerprint stamped into every manifest; a restart's
        # validate_resume compares it with the live job's
        self.fingerprint = fingerprint
        # elastic membership: a callable -> the transition log, called at
        # every save, so a shrink lands in the very next sidecar
        self.membership_provider = membership_provider
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.previous_checkpoints = {
            os.path.join(checkpoint_dir, f) for f in os.listdir(checkpoint_dir)
        }
        self.delete_queue = queue.Queue()
        self._start_deleter()
        _active_savers.add(self)

    def format_path(self, iteration):
        return os.path.join(
            self.checkpoint_dir, "{}.{}".format(CHECKPOINT_FILENAME, iteration)
        )

    def after_iteration(self, model, epoch, evals_log):
        _atomic_save(model, self.checkpoint_dir, "{}.{}".format(CHECKPOINT_FILENAME, epoch),
                     iteration=epoch, fingerprint=self.fingerprint,
                     membership_log=(self.membership_provider()
                                     if self.membership_provider else None))
        # /status carries the last saved checkpoint: the resume point of a
        # restart now
        from ..telemetry import fleet

        fleet.note_status(last_checkpoint={"path": self.format_path(epoch), "round": epoch})
        self.delete_queue.put(epoch - self.max_to_keep)
        if self.num_round is not None and epoch + 1 >= self.num_round:
            self.stop()
        return False

    def after_training(self, model):
        self.stop()
        return model

    # ------------------------------------------------------------- deleter
    def _start_deleter(self):
        def _is_uploading(path):
            return os.path.isfile(path + FILE_LOCK_SUFFIX) and not os.path.isfile(
                path + FILE_SAFE_SUFFIX
            )

        def _remove(path):
            try:
                try:
                    os.remove(path)
                except OSError:
                    # the checkpoint survived the delete: so does its sidecar
                    # (load_checkpoint sweeps it once the file is gone)
                    logger.debug("Failed to delete %s", path)
                else:
                    try:
                        os.remove(path + MANIFEST_SUFFIX)
                    except OSError:
                        pass
            finally:
                self.delete_queue.task_done()

        def _drain():
            for iteration in iter(self.delete_queue.get, self.SENTINEL):
                path = self.format_path(iteration)
                if not os.path.isfile(path) or path in self.previous_checkpoints:
                    self.delete_queue.task_done()
                    continue
                if _is_uploading(path):
                    # SageMaker still uploading: requeue and revisit later
                    time.sleep(0.5)
                    self.delete_queue.put(iteration)
                    continue
                _remove(path)
            self.delete_queue.task_done()
            # training over: second pass removes stragglers regardless of locks
            self.delete_queue.put(self.SENTINEL)
            for iteration in iter(self.delete_queue.get, self.SENTINEL):
                _remove(self.format_path(iteration))
            self.delete_queue.task_done()

        self.thread = threading.Thread(target=_drain, daemon=True)
        self.thread.start()

    def stop(self, timeout=None):
        """Drain and join the deleter; ``timeout`` bounds the join on the
        abort path."""
        if self.thread.is_alive():
            self.delete_queue.put(self.SENTINEL)
            self.thread.join(timeout)


class SaveIntermediateModelCallBack:
    """Overwrite ``model_dir/model_name`` after every round (master only)."""

    def __init__(self, intermediate_model_dir, model_name, is_master):
        self.intermediate_model_dir = intermediate_model_dir
        self.model_name = model_name
        self.is_master = is_master
        os.makedirs(intermediate_model_dir, exist_ok=True)

    def after_iteration(self, model, epoch, evals_log):
        if self.is_master:
            _atomic_save(model, self.intermediate_model_dir, self.model_name)
        return False
