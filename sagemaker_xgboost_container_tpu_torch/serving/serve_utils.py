"""Scoring-path utilities: payload parse, model load, predict, selectable
inference, response encoders.

* ``parse_content_data``: csv/libsvm/recordio -> DataMatrix,
* ``get_loaded_booster``: load every model file in the model dir (not
  dotfiles, not manifest sidecars) as an ensemble (env-gated), each file a
  pickled Booster (``PKL_FORMAT``) or xgboost JSON, UBJSON or legacy binary
  (``XGB_FORMAT``), onto the device, through the integrity checks of
  ``_load_verified``,
* ``predict``: feature-count checks per content type, best-iteration
  ranges, ensemble vote (softmax/hinge) or mean,
* selectable inference: the VALID_OBJECTIVES key matrix, per-key
  extraction, and csv/json/jsonlines/recordio encoders.

The predictor underneath is ``Forest.predict`` on the forest's device.
"""

import json
import logging
import os
import threading

import numpy as np
from scipy import stats

from .. import constants
from ..constants import (
    BINARY_HINGE,
    BINARY_LOG,
    BINARY_LOGRAW,
    MULTI_SOFTMAX,
    MULTI_SOFTPROB,
    REG_ABSOLUTEERR,
    REG_GAMMA,
    REG_LOG,
    REG_SQUAREDERR,
    REG_TWEEDIE,
)
from ..data.content_types import CSV, LIBSVM, RECORDIO_PROTOBUF, get_content_type
from ..data.recordio import _frame, encode_float32_tensor, encode_record
from ..models.compat import PKL_FORMAT, XGB_FORMAT, load_model_any_format  # noqa: F401
from ..models.forest import HOST_PREDICT_ROWS
from ..telemetry import REGISTRY
from ..utils import integrity
from ..utils.faults import fault_point
from . import encoder

logger = logging.getLogger(__name__)

# classification selectable inference keys
PREDICTED_LABEL = "predicted_label"
LABELS = "labels"
PROBABILITY = "probability"
PROBABILITIES = "probabilities"
RAW_SCORE = "raw_score"
RAW_SCORES = "raw_scores"
# regression selectable inference keys
PREDICTED_SCORE = "predicted_score"

TOP_LEVEL_OUT_KEY = "predictions"
SCORE_OUT_KEY = "score"

ALL_VALID_SELECT_KEYS = [
    PREDICTED_LABEL,
    LABELS,
    PROBABILITY,
    PROBABILITIES,
    RAW_SCORE,
    RAW_SCORES,
    PREDICTED_SCORE,
]

VALID_OBJECTIVES = {
    REG_SQUAREDERR: [PREDICTED_SCORE],
    REG_LOG: [PREDICTED_SCORE],
    REG_GAMMA: [PREDICTED_SCORE],
    REG_ABSOLUTEERR: [PREDICTED_SCORE],
    REG_TWEEDIE: [PREDICTED_SCORE],
    BINARY_LOG: [PREDICTED_LABEL, LABELS, PROBABILITY, PROBABILITIES, RAW_SCORE, RAW_SCORES],
    BINARY_LOGRAW: [PREDICTED_LABEL, LABELS, RAW_SCORE, RAW_SCORES],
    BINARY_HINGE: [PREDICTED_LABEL, LABELS, RAW_SCORE, RAW_SCORES],
    MULTI_SOFTMAX: [PREDICTED_LABEL, LABELS, RAW_SCORE, RAW_SCORES],
    MULTI_SOFTPROB: [PREDICTED_LABEL, LABELS, PROBABILITY, PROBABILITIES, RAW_SCORE, RAW_SCORES],
}


def parse_content_data(input_data, input_content_type):
    """Request body + content type -> (DataMatrix, canonical content type)."""
    # both serving apps decode here: an error drills the 415 answer, a sleep
    # the decode-stage deadline
    fault_point("serving.decode", content_type=input_content_type)
    content_type = get_content_type(input_content_type)
    payload = input_data
    if content_type == CSV:
        try:
            decoded = payload.strip().decode("utf-8")
            dtest = encoder.csv_to_matrix(decoded, dtype=float)
        except Exception as e:
            raise RuntimeError(
                "Loading csv data failed with Exception, please ensure data "
                "is in csv format:\n {}\n {}".format(type(e), e)
            )
    elif content_type == LIBSVM:
        try:
            decoded = payload.strip().decode("utf-8")
            dtest = encoder.libsvm_to_matrix(decoded)
        except Exception as e:
            raise RuntimeError(
                "Loading libsvm data failed with Exception, please ensure data "
                "is in libsvm format:\n {}\n {}".format(type(e), e)
            )
    elif content_type == RECORDIO_PROTOBUF:
        try:
            dtest = encoder.recordio_protobuf_to_matrix(payload)
        except Exception as e:
            raise RuntimeError(
                "Loading recordio-protobuf data failed with Exception, please "
                "ensure data is in recordio-protobuf format: {} {}".format(type(e), e)
            )
    else:
        raise RuntimeError("Content-type {} is not supported.".format(input_content_type))
    return dtest, content_type


def _get_full_model_paths(model_dir):
    for name in sorted(os.listdir(model_dir)):
        path = os.path.join(model_dir, name)
        # a manifest sidecar describes a model file and is never one
        if (os.path.isfile(path) and not name.startswith(".")
                and not name.endswith(integrity.MANIFEST_SUFFIX)):
            yield path


def _note_model_verify_fail(stage):
    REGISTRY.counter(
        "model_verify_fail_total",
        "Serving model artifacts rejected at load (digest, parse, or structural validation)",
        {"stage": stage},
    ).inc()


_drift_noted = threading.Event()


def _load_verified(path, device=None):
    """Load one model file onto ``device`` through three checks, each
    counted in ``model_verify_fail_total{stage}`` when it fails: ``digest``
    (the bytes disagree with the manifest sidecar that travels with the
    file), ``parse`` (no supported format loads it) and ``structure`` (the
    trees break the invariants the traversal assumes). A corrupt artifact
    fails here, at load, instead of answering garbage at predict time.
    -> (Forest, format tag)."""
    fault_point("model.load", path=path)
    manifest = integrity.read_manifest(path)
    if manifest is not None:
        try:
            integrity.verify_file_against_manifest(path, manifest)
        except (integrity.IntegrityError, OSError) as e:
            _note_model_verify_fail("digest")
            logger.error("MODEL VERIFICATION FAILED (digest): %s", e)
            raise integrity.IntegrityError(
                "Model artifact {} failed digest verification against its manifest: {}".format(
                    path, e))
        if manifest.get("drift_baseline") and not _drift_noted.is_set():
            _drift_noted.set()
            logger.info("%s: the manifest's drift_baseline is ignored (no drift monitor in "
                        "this package)", path)
    try:
        forest, source_format = load_model_any_format(path, device=device)
    except Exception as e:
        _note_model_verify_fail("parse")
        logger.error("MODEL VERIFICATION FAILED (parse): %s: %s", path, e)
        raise
    try:
        integrity.validate_model(forest)
    except integrity.IntegrityError as e:
        _note_model_verify_fail("structure")
        logger.error("MODEL VERIFICATION FAILED (structure): %s: %s", path, e)
        raise integrity.IntegrityError(
            "Model artifact {} is structurally invalid: {}".format(path, e))
    return forest, source_format


def get_loaded_booster(model_dir, ensemble=False, device=None):
    """Load model file(s) from the directory onto ``device``, each through
    ``_load_verified``; ensemble loads all of them. -> (Forest or list of
    Forest, format tag or list)."""
    paths = list(_get_full_model_paths(model_dir))
    if not paths:
        raise RuntimeError("No model files found in {}".format(model_dir))
    paths = paths if ensemble else paths[:1]
    models, formats = [], []
    for path in paths:
        forest, source_format = _load_verified(path, device=device)
        models.append(forest)
        formats.append(source_format)
    if ensemble and len(models) > 1:
        return models, formats
    return models[0], formats[0]


def _check_feature_count(forest, dtest, content_type):
    x = forest.num_feature
    y = dtest.num_col
    if content_type == LIBSVM:
        if y > x + 1:
            raise ValueError(
                "Feature size of libsvm inference data {} is larger than feature size "
                "of trained model {}.".format(y, x)
            )
    elif content_type in (CSV, RECORDIO_PROTOBUF):
        if not (x == y or x == y + 1):
            raise ValueError(
                "Feature size of {} inference data {} is not consistent with feature "
                "size of trained model {}.".format(content_type, y, x)
            )
    else:
        raise ValueError("Content type {} is not supported".format(content_type))


def canonicalize_features(forest, dtest):
    """Width-adjust request features to the model's expectation."""
    features = dtest.features
    if features.shape[1] < forest.num_feature:
        features = dtest.pad_features(forest.num_feature).features
    elif features.shape[1] > forest.num_feature:
        features = features[:, : forest.num_feature]
    return features


def best_iteration_range(forest):
    best_iteration = forest.attributes.get("best_iteration")
    if best_iteration is None:
        return None
    return (0, int(best_iteration) + 1)


def warmup_predict_async(model):
    """Predict HOST_PREDICT_ROWS + 1 zero rows, the smallest payload that
    takes the device path, on a daemon thread at model load. That pays for
    the device context on this process and the upload of the stacked trees
    off the request path, so the first request does not. A failed warmup
    only logs; the request that follows then raises the same error."""

    def _warm():
        try:
            for m in model if isinstance(model, list) else [model]:
                if m.num_feature > 0:
                    m.predict(
                        np.zeros((HOST_PREDICT_ROWS + 1, m.num_feature), np.float32),
                        iteration_range=best_iteration_range(m),
                    )
        except Exception:  # a failed warmup must never break serving
            logger.exception("predict warmup failed")

    thread = threading.Thread(target=_warm, daemon=True, name="predict-warmup")
    thread.start()
    return thread


def predict(model, model_format, dtest, input_content_type, objective=None):
    """Run (possibly ensemble) prediction with feature-size validation."""
    boosters = model if isinstance(model, list) else [model]
    content_type = get_content_type(input_content_type)
    _check_feature_count(boosters[0], dtest, content_type)

    def _one(forest):
        return forest.predict(
            canonicalize_features(forest, dtest),
            iteration_range=best_iteration_range(forest),
        )

    if isinstance(model, list):
        outs = [_one(b) for b in boosters]
        if objective in (MULTI_SOFTMAX, BINARY_HINGE):
            return stats.mode(np.stack(outs), axis=0, keepdims=False).mode
        return np.mean(outs, axis=0)
    return _one(model)


def is_selectable_inference_output():
    return constants.SAGEMAKER_INFERENCE_OUTPUT in os.environ


def get_selected_output_keys():
    if is_selectable_inference_output():
        return os.environ[constants.SAGEMAKER_INFERENCE_OUTPUT].replace(" ", "").lower().split(",")
    raise RuntimeError(
        "'SAGEMAKER_INFERENCE_OUTPUT' environment variable is not present. "
        "Selectable inference content is not enabled."
    )


def _get_labels(objective, num_class=""):
    if "binary:" in objective:
        return [0, 1]
    if "multi:" in objective and num_class:
        return list(range(int(num_class)))
    return np.nan


def _get_predicted_label(objective, raw_prediction):
    if objective in (BINARY_HINGE, MULTI_SOFTMAX):
        return np.asarray(raw_prediction).item()
    if objective == BINARY_LOG:
        return int(raw_prediction > 0.5)
    if objective == BINARY_LOGRAW:
        return int(raw_prediction > 0)
    if objective == MULTI_SOFTPROB:
        return int(np.argmax(raw_prediction))
    return np.nan


def _get_probability(objective, raw_prediction):
    if objective == MULTI_SOFTPROB:
        return float(max(raw_prediction))
    if objective == BINARY_LOG:
        return float(raw_prediction)
    return np.nan


def _get_probabilities(objective, raw_prediction):
    if objective == MULTI_SOFTPROB:
        return np.asarray(raw_prediction).tolist()
    if objective == BINARY_LOG:
        p1 = float(raw_prediction)
        return [1.0 - p1, p1]
    return np.nan


def _get_raw_score(objective, raw_prediction):
    if objective == MULTI_SOFTPROB:
        return float(max(raw_prediction))
    if objective in (BINARY_LOGRAW, BINARY_HINGE, BINARY_LOG, MULTI_SOFTMAX):
        return float(raw_prediction)
    return np.nan


def _get_raw_scores(objective, raw_prediction):
    if objective == MULTI_SOFTPROB:
        return np.asarray(raw_prediction).tolist()
    if objective in (BINARY_LOGRAW, BINARY_HINGE, BINARY_LOG, MULTI_SOFTMAX):
        p1 = float(raw_prediction)
        return [1.0 - p1, p1]
    return np.nan


def get_selected_predictions(raw_predictions, selected_keys, objective, num_class=""):
    """Per-row dicts of the selected content keys."""
    if objective not in VALID_OBJECTIVES:
        raise ValueError(
            "Objective `{}` unsupported for selectable inference predictions.".format(objective)
        )
    valid = set(selected_keys) & set(VALID_OBJECTIVES[objective])
    invalid = set(selected_keys) - set(VALID_OBJECTIVES[objective])

    predictions = []
    for raw in raw_predictions:
        out = {}
        if PREDICTED_LABEL in valid:
            out[PREDICTED_LABEL] = _get_predicted_label(objective, raw)
        if LABELS in valid:
            out[LABELS] = _get_labels(objective, num_class=num_class)
        if PROBABILITY in valid:
            out[PROBABILITY] = _get_probability(objective, raw)
        if PROBABILITIES in valid:
            out[PROBABILITIES] = _get_probabilities(objective, raw)
        if RAW_SCORE in valid:
            out[RAW_SCORE] = _get_raw_score(objective, raw)
        if RAW_SCORES in valid:
            out[RAW_SCORES] = _get_raw_scores(objective, raw)
        if PREDICTED_SCORE in valid:
            out[PREDICTED_SCORE] = float(np.asarray(raw).item())
        for key in invalid:
            out[key] = np.nan
        predictions.append(out)
    return predictions


def _encode_selected_predictions_csv(predictions, ordered_keys_list):
    lines = []
    for prediction in predictions:
        cells = []
        for key in ordered_keys_list:
            value = prediction[key]
            cells.append('"{}"'.format(value) if isinstance(value, list) else str(value))
        lines.append(",".join(cells))
    return "\n".join(lines)


def _encode_selected_predictions_recordio_protobuf(predictions):
    out = []
    for item in predictions:
        label = {
            key: encode_float32_tensor(value if isinstance(value, list) else [value])
            for key, value in item.items()
        }
        out.append(_frame(encode_record(label=label)))
    return b"".join(out)


def encode_selected_predictions(predictions, selected_content_keys, accept):
    if accept == "application/json":
        return json.dumps({TOP_LEVEL_OUT_KEY: predictions})
    if accept == "application/jsonlines":
        return encoder.json_to_jsonlines({TOP_LEVEL_OUT_KEY: predictions})
    if accept == "application/x-recordio-protobuf":
        return _encode_selected_predictions_recordio_protobuf(predictions)
    if accept == "text/csv":
        csv_response = _encode_selected_predictions_csv(predictions, selected_content_keys)
        if os.getenv(constants.SAGEMAKER_BATCH):
            return csv_response + "\n"
        return csv_response
    raise RuntimeError("Cannot encode selected predictions into accept type '{}'.".format(accept))


def encode_predictions_as_json(predictions):
    """``{"predictions": [{"score": ...}, ...]}`` (SageMaker CDF format)."""
    return json.dumps(
        {TOP_LEVEL_OUT_KEY: [{SCORE_OUT_KEY: pred} for pred in predictions]}
    )


def is_ensemble_enabled():
    return os.environ.get(constants.SAGEMAKER_INFERENCE_ENSEMBLE, "true") == "true"
