"""Out-of-fold prediction recorder for repeated k-fold CV.

The port's counterpart of ``sagemaker_xgboost_container_tpu/training/prediction_utils.py``:
collects each row's validation-fold predictions across the repeats,
aggregates them (the mean for regression and probabilities, the most
frequent label for classes, the smallest on a tie, as ``scipy.stats.mode``
takes it) and writes ``predictions.csv`` to SM_OUTPUT_DATA_DIR.
"""

import logging
import os

import numpy as np

from ..toolkit import exceptions as exc

PREDICTIONS_OUTPUT_FILE = "predictions.csv"
EXAMPLE_ROWS_EXCEPTION_COUNT = 100

logger = logging.getLogger(__name__)


def _row_mode(values):
    """Per row of [n, R]: the most frequent value, the smallest on a tie."""
    classes = np.unique(values)
    counts = (values[:, :, None] == classes).sum(axis=1)
    return classes[np.argmax(counts, axis=1)]


class ValidationPredictionRecorder:
    def __init__(self, y_true, num_cv_round, classification, output_data_dir):
        self.y_true = np.asarray(y_true).copy()
        n = len(self.y_true)
        self.num_cv_round = num_cv_round
        self.y_pred = np.zeros((n, num_cv_round))
        self.y_prob = self.y_pred.copy() if classification else None
        self.cv_repeat_counter = np.zeros(n, dtype=int)
        self.classification = classification
        self.output_data_dir = output_data_dir
        self._pred_ndim = None

    def record(self, indices, predictions):
        predictions = np.asarray(predictions)
        if self._pred_ndim is None:
            self._pred_ndim = predictions.ndim
        elif self._pred_ndim != predictions.ndim:
            raise exc.AlgorithmError(
                "Expected predictions with ndim={}, got ndim={}.".format(
                    self._pred_ndim, predictions.ndim
                )
            )
        repeat_idx = self.cv_repeat_counter[indices]
        if np.any(repeat_idx == self.num_cv_round):
            rows = repeat_idx[repeat_idx == self.num_cv_round][:EXAMPLE_ROWS_EXCEPTION_COUNT]
            raise exc.AlgorithmError(
                "More than {} repeated predictions for same row were provided. "
                "Example row indices where this is the case: {}.".format(
                    self.num_cv_round, rows
                )
            )
        if self.classification:
            if predictions.ndim > 1:
                labels = np.argmax(predictions, axis=-1)
                proba = predictions[np.arange(len(labels)), labels]
            else:
                labels = (predictions > 0.5).astype(int)
                proba = predictions
            self.y_pred[indices, repeat_idx] = labels
            self.y_prob[indices, repeat_idx] = proba
        else:
            self.y_pred[indices, repeat_idx] = predictions
        self.cv_repeat_counter[indices] += 1

    def _aggregate(self):
        if not np.all(self.cv_repeat_counter == self.num_cv_round):
            rows = self.cv_repeat_counter[
                self.cv_repeat_counter != self.num_cv_round
            ][:EXAMPLE_ROWS_EXCEPTION_COUNT]
            raise exc.AlgorithmError(
                "For some rows number of repeated validation set predictions provided "
                "is not {}. Example row indices where this is the case: {}".format(
                    self.num_cv_round, rows
                )
            )
        columns = [self.y_true]
        if self.classification:
            columns.append(self.y_prob.mean(axis=-1))
            columns.append(_row_mode(self.y_pred))
        else:
            columns.append(self.y_pred.mean(axis=-1))
        return np.vstack(columns).T

    def save(self):
        os.makedirs(self.output_data_dir, exist_ok=True)
        path = os.path.join(self.output_data_dir, PREDICTIONS_OUTPUT_FILE)
        logger.info("Storing predictions on validation set(s) in %s", path)
        np.savetxt(path, self._aggregate(), delimiter=",", fmt="%f")
