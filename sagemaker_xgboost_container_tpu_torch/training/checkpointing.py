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
  a fresh model behind.

The JAX package also writes an integrity manifest beside each checkpoint;
the port writes none but verifies them on load, so it resumes from the JAX
package's checkpoints as the JAX package does and the JAX package from the
port's.
"""

import json
import logging
import os
import queue
import re
import tempfile
import threading
import time

from ..utils import integrity

TEMP_FILE_SUFFIX = ".sagemaker-ignore"
FILE_LOCK_SUFFIX = ".sagemaker-uploading"
FILE_SAFE_SUFFIX = ".sagemaker-uploaded"
MANIFEST_SUFFIX = integrity.MANIFEST_SUFFIX

CHECKPOINT_FILENAME = "xgboost-checkpoint"

logger = logging.getLogger(__name__)


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
            return False
        except OSError:
            return False
    try:
        with open(path, "rb") as f:
            json.loads(f.read().decode("utf-8"))
        return True
    except (OSError, ValueError, UnicodeDecodeError):
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


def _atomic_save(model, directory, final_name):
    """Save ``model`` to a temp file in ``directory``, then rename it to
    ``final_name``; a failed save leaves no temp file behind. A sidecar of
    ``final_name`` (a JAX package's manifest of the bytes being replaced)
    is removed before the rename, so it never describes the new bytes."""
    with tempfile.NamedTemporaryFile(
        dir=directory, suffix=TEMP_FILE_SUFFIX, delete=False, mode="w"
    ) as tf:
        tmp = tf.name
    try:
        model.save_model(tmp)
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


class SaveCheckpointCallBack:
    """Save a checkpoint each round; background-delete stale ones."""

    SENTINEL = None

    def __init__(self, checkpoint_dir, max_to_keep=5, num_round=None):
        self.checkpoint_dir = checkpoint_dir
        self.max_to_keep = max_to_keep
        self.num_round = num_round
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.previous_checkpoints = {
            os.path.join(checkpoint_dir, f) for f in os.listdir(checkpoint_dir)
        }
        self.delete_queue = queue.Queue()
        self._start_deleter()

    def format_path(self, iteration):
        return os.path.join(
            self.checkpoint_dir, "{}.{}".format(CHECKPOINT_FILENAME, iteration)
        )

    def after_iteration(self, model, epoch, evals_log):
        _atomic_save(model, self.checkpoint_dir, "{}.{}".format(CHECKPOINT_FILENAME, epoch))
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
                os.remove(path)
            except OSError:
                logger.debug("Failed to delete %s", path)
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
        """Drain and join the deleter."""
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
