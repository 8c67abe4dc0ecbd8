"""Training callbacks: evaluation monitor (the HPO stdout contract), early
stopping, checkpoint assembly, SIGTERM model save.

The port's counterpart of ``sagemaker_xgboost_container_tpu/training/callbacks.py``.
The EvaluationMonitor line format is load-bearing: SageMaker HPO scrapes
``.*\\[[0-9]+\\].*#011validation-<metric>:(\\S+)`` from stdout (the tab
renders as #011 in CloudWatch), so the monitor prints
``[<iter>]<TAB><data>-<metric>:<value:.5f>...`` exactly.
"""

import logging
import os
import signal

from ..constants import MODEL_NAME, XGB_MAXIMIZE_METRICS
from ..toolkit import exceptions as exc
from . import checkpointing, train_utils

logger = logging.getLogger(__name__)


class EvaluationMonitor:
    """Print one stdout line per round in xgboost's format."""

    def after_iteration(self, model, epoch, evals_log):
        parts = [
            "{}-{}:{:.5f}".format(data_name, metric_name, values[-1])
            for data_name, metrics in evals_log.items()
            for metric_name, values in metrics.items()
        ]
        if parts:
            print("[{}]\t{}".format(epoch, "\t".join(parts)), flush=True)
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

    def _improved(self, score):
        if self.best_score is None:
            return True
        return score > self.best_score if self.maximize else score < self.best_score

    def after_iteration(self, model, epoch, evals_log):
        series = evals_log.get(self.data_name, {}).get(self.metric_name)
        if not series:
            return False
        score = series[-1]
        if self._improved(score):
            self.best_score = score
            self.best_iteration = epoch
            self.stagnation = 0
            return False
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
):
    """-> (xgb_model path or None, start iteration, callback list).

    Order: monitor, checkpoint saver (master only), intermediate model +
    SIGTERM handler, early stopping. A cross-validation ``fold`` keeps its
    checkpoints in ``model-{fold}`` under ``checkpoint_dir`` and its
    intermediate model as ``xgboost-model-{fold}``.
    """
    if checkpoint_dir and fold is not None:
        checkpoint_dir = os.path.join(checkpoint_dir, "model-{}".format(fold))
    xgb_model, iteration = checkpointing.load_checkpoint(checkpoint_dir)
    if xgb_model is not None:
        logger.info("Checkpoint loaded from %s", xgb_model)
        logger.info("Resuming from iteration %s", iteration)

    callbacks = [EvaluationMonitor()]

    if checkpoint_dir and is_master:
        callbacks.append(
            checkpointing.SaveCheckpointCallBack(checkpoint_dir, num_round=num_round)
        )

    if save_model_on_termination == "true" and is_master:
        model_name = "{}-{}".format(MODEL_NAME, fold) if fold is not None else MODEL_NAME
        callbacks.append(
            checkpointing.SaveIntermediateModelCallBack(model_dir, model_name, is_master)
        )
        add_sigterm_handler(model_dir, is_master)

    if early_stopping_data_name and early_stopping_metric and early_stopping_rounds:
        callbacks.append(
            EarlyStopping(
                rounds=early_stopping_rounds,
                data_name=early_stopping_data_name,
                metric_name=early_stopping_metric,
                # ndcg@10 and map@5 rise as ndcg and map do
                maximize=early_stopping_metric.partition("@")[0] in XGB_MAXIMIZE_METRICS,
                save_best=is_master,
            )
        )

    return xgb_model, iteration, callbacks
