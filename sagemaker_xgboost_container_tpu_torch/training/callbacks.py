"""Training callbacks: evaluation monitor (the HPO stdout contract), early
stopping, checkpoint assembly, SIGTERM model save.

The port's counterpart of ``sagemaker_xgboost_container_tpu/training/callbacks.py``.
The EvaluationMonitor line format is load-bearing: SageMaker HPO scrapes
``.*\\[[0-9]+\\].*#011validation-<metric>:(\\S+)`` from stdout (the tab
renders as #011 in CloudWatch), so the monitor prints
``[<iter>]<TAB><data>-<metric>:<value:.5f>...`` exactly.

Every callback but the watchdog and ``RoundTimer`` runs inside a
``_TimedCallback``, whose span feeds the round record's ``phases_ms``.
"""

import logging
import os
import signal
import sys

from ..constants import MODEL_NAME, XGB_MAXIMIZE_METRICS
from ..telemetry import span
from ..toolkit import exceptions as exc
from . import checkpointing, train_utils

logger = logging.getLogger(__name__)


class _TimedCallback:
    """Delegate that times the inner callback's ``after_iteration`` as the
    named phase (the round record's ``phases_ms`` and the
    ``training_phase_seconds`` histogram). Unknown attributes forward to
    ``inner``, so duck-typed checks (dart's ``save_best`` guard) see
    through it."""

    def __init__(self, inner, phase):
        self.inner = inner
        self.phase = phase

    def __getattr__(self, name):
        # reached only for attributes the wrapper lacks; guard 'inner'
        # against recursion before __init__ (copy and the like)
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def before_training(self, model):
        if hasattr(self.inner, "before_training"):
            return self.inner.before_training(model)
        return model

    def after_iteration(self, model, epoch, evals_log):
        if not hasattr(self.inner, "after_iteration"):
            return False
        with span(self.phase):
            return self.inner.after_iteration(model, epoch, evals_log)

    def after_training(self, model):
        if hasattr(self.inner, "after_training"):
            return self.inner.after_training(model)
        return model


class EvaluationMonitor:
    """Print one stdout line per round in xgboost's format.

    Under the host cadence of K rounds a dispatch (metrics without a device
    form are evaluated once a dispatch, ``models/booster.py``) the rounds
    in between add no entries, and print nothing: their round index beside
    the previous values would misreport.

    Under ``SM_MODEL_TELEMETRY`` each printed entry is also emitted as a
    ``training.eval`` record and folded into the learning curve
    (``telemetry/model.note_eval``); the stdout line, the HPO contract,
    stays byte-identical either way."""

    def __init__(self):
        from ..telemetry import model as model_telemetry

        self._model_telemetry = model_telemetry.enabled() and model_telemetry
        self._entries_seen = 0

    def after_iteration(self, model, epoch, evals_log):
        fresh = [
            (data_name, metric_name, values[-1])
            for data_name, metrics in evals_log.items()
            for metric_name, values in metrics.items()
        ]
        total = sum(len(values) for metrics in evals_log.values() for values in metrics.values())
        if fresh and total != self._entries_seen:
            self._entries_seen = total
            # one write: a host's local ranks share its stdout, and where
            # Python's output is unbuffered print writes the text and the
            # newline apart, so a worker's log line could land between them
            sys.stdout.write("[{}]\t{}\n".format(epoch, "\t".join(
                "{}-{}:{:.5f}".format(d, m, v) for d, m, v in fresh)))
            sys.stdout.flush()
            if self._model_telemetry:
                from ..telemetry import emit_metric

                for data_name, metric_name, value in fresh:
                    emit_metric("training.eval", round=int(epoch), dataset=data_name,
                                name=metric_name, value=float(value))
                    self._model_telemetry.note_eval(epoch, data_name, metric_name, value)
        return False


class EarlyStopping:
    """Stop after ``rounds`` non-improving rounds on (data_name, metric_name).

    With save_best, the forest is truncated to the best iteration after
    training (xgboost EarlyStopping(save_best=True) semantics); a linear
    model has no iterations to cut, and raises.
    """

    def __init__(self, rounds, data_name, metric_name, maximize, save_best=False):
        self.rounds = rounds
        self.data_name = data_name
        self.metric_name = metric_name
        self.maximize = maximize
        self.save_best = save_best
        self.best_score = None
        self.best_iteration = 0
        self.stagnation = 0
        self._entries_seen = 0

    def _improved(self, score):
        if self.best_score is None:
            return True
        return score > self.best_score if self.maximize else score < self.best_score

    def after_iteration(self, model, epoch, evals_log):
        series = evals_log.get(self.data_name, {}).get(self.metric_name)
        if not series or len(series) == self._entries_seen:
            # no fresh value this round (the host cadence evaluates once a
            # K-round dispatch): a repeat is no evidence, no decision
            return False
        self._entries_seen = len(series)
        score = series[-1]
        if self._improved(score):
            self.best_score = score
            self.best_iteration = epoch
            self.stagnation = 0
            return False
        # patience counts rounds since the best one, not fresh values: under
        # the once-a-dispatch cadence a count of values would multiply
        # early_stopping_rounds by K
        self.stagnation = epoch - self.best_iteration
        return self.stagnation >= self.rounds

    def after_training(self, model):
        model.attributes["best_iteration"] = str(self.best_iteration)
        if self.best_score is not None:
            model.attributes["best_score"] = str(self.best_score)
        if self.save_best and not hasattr(model, "iteration_indptr"):
            raise exc.UserError(
                "early_stopping with save_best is not supported for booster=gblinear; "
                "the linear model cannot be truncated to a past iteration."
            )
        if self.save_best:
            # truncate to the best round (iteration indices are absolute)
            end_tree = model.iteration_indptr[self.best_iteration + 1]
            model.trees = model.trees[:end_tree]
            model.tree_info = model.tree_info[:end_tree]
            model.iteration_indptr = model.iteration_indptr[: self.best_iteration + 2]
            model.to(model.device)  # drops the stacked trees of the longer forest
        return model


def add_sigterm_handler(model_dir, is_master):
    """On SIGTERM: master cleans stale files from model_dir, all exit 0."""

    def _cleanup_and_exit(signo, frame):
        from ..parallel import local

        local.kill_local_ranks()
        if is_master:
            train_utils.cleanup_dir(model_dir, MODEL_NAME)
        os._exit(0)

    signal.signal(signal.SIGTERM, _cleanup_and_exit)


def get_callbacks(
    model_dir,
    checkpoint_dir,
    early_stopping_data_name,
    early_stopping_metric,
    early_stopping_rounds,
    save_model_on_termination,
    is_master,
    fold=None,
    num_round=None,
    num_rows=None,
    train_cfg=None,
):
    """-> (xgb_model path or None, start iteration, callback list).

    Order, the JAX package's: monitor, the consensus guard
    (``SM_CONSENSUS_EVERY``), checkpoint saver (master only), intermediate
    model + SIGTERM handler, the elastic drain point (``SM_ELASTIC``), early
    stopping, the round watchdog (``SM_ROUND_DEADLINE_S``), and
    ``RoundTimer`` last, so each round's record drains the phases the
    callbacks before it recorded. A
    cross-validation ``fold`` keeps its checkpoints in ``model-{fold}``
    under ``checkpoint_dir`` and its intermediate model as
    ``xgboost-model-{fold}``.

    ``train_cfg``, when given, feeds the integrity layer: its config
    fingerprint is stamped into every checkpoint manifest and checked
    against the resume candidate's (a warning, or a refusal under
    ``SM_RESUME_STRICT=true``); a world-size change that the elastic
    membership log records resumes cleanly.
    """
    from ..utils import integrity
    from . import elastic

    if checkpoint_dir and fold is not None:
        checkpoint_dir = os.path.join(checkpoint_dir, "model-{}".format(fold))
    fingerprint = integrity.config_fingerprint(train_cfg) if train_cfg is not None else None
    xgb_model, iteration = checkpointing.load_checkpoint(checkpoint_dir)
    if xgb_model is not None:
        if fingerprint is not None:
            integrity.validate_resume(xgb_model, fingerprint,
                                      membership_log=elastic.membership_log())
        logger.info("Checkpoint loaded from %s", xgb_model)
        logger.info("Resuming from iteration %s", iteration)

    from ..parallel import local

    # a host's workers (its local ranks other than the leader) print no
    # metric lines (the HPO regex reads one line a round a host) and no
    # round records, run no consensus guard (one digest a host) and no round
    # watchdog (the leader's takes the host down)
    worker = local.is_worker()
    callbacks = [] if worker else [_TimedCallback(EvaluationMonitor(), "eval_monitor")]

    # the consensus guard (SM_CONSENSUS_EVERY): before the checkpoint saver,
    # so that on the round it finds a divergence the abort comes before that
    # round's checkpoint, and a restart resumes from a round that passed
    from .consensus import maybe_consensus_guard

    guard = None if worker else maybe_consensus_guard()
    if guard is not None:
        callbacks.append(_TimedCallback(guard, "consensus"))

    if checkpoint_dir and is_master:
        callbacks.append(_TimedCallback(
            checkpointing.SaveCheckpointCallBack(
                checkpoint_dir, start_iteration=iteration, num_round=num_round,
                fingerprint=fingerprint, membership_provider=elastic.membership_log),
            "checkpoint",
        ))

    if save_model_on_termination == "true" and is_master:
        model_name = "{}-{}".format(MODEL_NAME, fold) if fold is not None else MODEL_NAME
        callbacks.append(_TimedCallback(
            checkpointing.SaveIntermediateModelCallBack(model_dir, model_name, is_master),
            "intermediate_save",
        ))
        add_sigterm_handler(model_dir, is_master)

    # the elastic drain point (SM_ELASTIC): after the savers, so the round
    # that just finished is on disk before the loop unwinds, and before
    # early stopping, so a reform round never counts as stagnation
    elastic_cb = elastic.maybe_elastic_callback()
    if elastic_cb is not None:
        callbacks.append(_TimedCallback(elastic_cb, "elastic"))

    if early_stopping_data_name and early_stopping_metric and early_stopping_rounds:
        callbacks.append(_TimedCallback(
            EarlyStopping(
                rounds=early_stopping_rounds,
                data_name=early_stopping_data_name,
                metric_name=early_stopping_metric,
                # ndcg@10 and map@5 rise as ndcg and map do
                maximize=early_stopping_metric.partition("@")[0] in XGB_MAXIMIZE_METRICS,
                save_best=is_master,
            ),
            "early_stopping",
        ))

    # round watchdog (SM_ROUND_DEADLINE_S): a stalled round flushes the
    # checkpoints and exits 79
    from .watchdog import maybe_round_watchdog

    watchdog = None if worker else maybe_round_watchdog()
    if watchdog is not None:
        callbacks.append(watchdog)

    # LAST: each round's record drains the phases the callbacks above
    # recorded for that round. Per-round log lines stay opt-in
    # (SM_ROUND_TIMING); the structured record is the telemetry contract
    from .profiling import RoundTimer

    round_timing = os.environ.get("SM_ROUND_TIMING", "").lower() in ("1", "true")
    # (a worker's keeps the round-end fault point, and emits nothing)
    callbacks.append(RoundTimer(num_rows=num_rows,
                                log_every=10 if round_timing and not worker else 0,
                                emit_structured=not worker, fold=fold))
    return xgb_model, iteration, callbacks
