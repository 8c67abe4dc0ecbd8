"""Algorithm-mode training orchestration: ``sagemaker_train`` + ``train_job``.

The port's counterpart of ``sagemaker_xgboost_container_tpu/training/algorithm_train.py``
for one host: validate hyperparameters and channels, load and check the
data matrices, run boosting with the callback stack (metric lines,
checkpoints, intermediate model, early stopping) on one device, and save
the model under ``xgboost-model``. Errors matching the known customer
substrings re-raise as UserError. The validated hyperparameters, among them
``num_class`` and the objective parameters (``tweedie_variance_power``,
``huber_slope``, ``aft_loss_distribution``, ...), go to ``booster.train``
as they are; without ``eval_metric`` the objective's default metric makes
the metric lines the tuner reads.

Every objective trains, the ranking ones with the query groups of the
channel (libsvm ``qid:`` tokens or ``.group`` sidecar files; a csv channel,
or one without groups, is one group of all its rows), with depthwise or
lossguide growth; ranking metric lines read ``validation-ndcg@10`` and so
on. Not ported yet, each refused with a ``UserError`` naming it: more than
one host (``SM_HOSTS``), k-fold cross-validation (``_kfold``, which needs a
fold splitter in place of sklearn's), custom (sklearn) metrics, and what
``booster.TrainConfig`` refuses: row and column sampling,
``num_parallel_tree`` above 1, constraints, dart, gblinear,
``process_type=update`` and the exact and approx tree methods.
"""

import logging
import os

from .._device import resolve_device
from ..algorithm import channels as cv
from ..algorithm import hyperparameters as hpv
from ..algorithm import metrics as metrics_mod
from ..constants import CUSTOMER_ERRORS, MODEL_NAME, PIPE_MODE
from ..data.content_types import get_content_type
from ..data.readers import (
    check_data_redundancy,
    get_data_matrix,
    get_size,
    validate_data_file_path,
)
from ..models import booster
from ..toolkit import exceptions as exc
from . import train_utils
from .callbacks import get_callbacks

logger = logging.getLogger(__name__)


def get_validated_data_matrices(
    train_path, validate_path, content_type, csv_weights=0, is_pipe=False,
    combine_train_val=False,
):
    """Size/format-check both channels and parse them into DataMatrix objects."""
    train_size = get_size(train_path, is_pipe) if train_path else 0
    val_size = get_size(validate_path, is_pipe) if validate_path else 0

    if not is_pipe:
        if train_size > 0:
            validate_data_file_path(train_path, content_type)
        if val_size > 0:
            validate_data_file_path(validate_path, content_type)

    train_dmatrix = (
        get_data_matrix(train_path, content_type, csv_weights=csv_weights, is_pipe=is_pipe)
        if train_size > 0
        else None
    )
    val_dmatrix = (
        get_data_matrix(validate_path, content_type, csv_weights=csv_weights, is_pipe=is_pipe)
        if val_size > 0
        else None
    )

    train_val_dmatrix = train_dmatrix
    if combine_train_val and train_dmatrix is not None and val_dmatrix is not None:
        logger.info("Read both train and validation data into one DataMatrix")
        train_val_dmatrix = train_dmatrix.concat(val_dmatrix)
    return train_dmatrix, val_dmatrix, train_val_dmatrix


def sagemaker_train(
    train_config,
    data_config,
    train_path,
    val_path,
    model_dir,
    sm_hosts,
    sm_current_host,
    checkpoint_config,
    device=None,
):
    """Validate config, load data, run train_job on ``device`` (CUDA unless
    given; raises without a GPU unless ``device="cpu"``, once the
    hyperparameters and channels have been validated)."""
    metrics = metrics_mod.initialize()
    hyperparameters = hpv.initialize(metrics)
    validated_train_config = hyperparameters.validate(train_config)
    if validated_train_config.get("updater"):
        validated_train_config["updater"] = ",".join(validated_train_config["updater"])

    channels = cv.initialize()
    validated_data_config = channels.validate(data_config)

    file_type = get_content_type(validated_data_config["train"].get("ContentType"))
    input_mode = validated_data_config["train"].get("TrainingInputMode")
    csv_weights = validated_train_config.get("csv_weights", 0)
    is_pipe = input_mode == PIPE_MODE

    validation_channel = validated_data_config.get("validation", None)
    if "_kfold" in validated_train_config:
        raise exc.UserError(
            "k-fold cross-validation (_kfold) is not supported by the PyTorch port yet"
        )
    num_hosts = len(sm_hosts)
    if num_hosts > 1:
        raise exc.UserError(
            "distributed training over {} hosts is not supported by the PyTorch port "
            "yet; train on one host".format(num_hosts)
        )
    if val_path is not None:
        if train_path == val_path or os.path.basename(train_path) == os.path.basename(val_path):
            logger.warning(
                "Found same path for training and validation. This is not recommended "
                "and results may not be correct."
            )
        elif not is_pipe:
            check_data_redundancy(train_path, val_path)

    checkpoint_dir = checkpoint_config.get("LocalPath", None)

    if validated_train_config.pop("use_dask_gpu_training", "false") == "true":
        raise exc.UserError(
            "use_dask_gpu_training is not supported by the PyTorch port: it trains on "
            "one GPU; remove this hyperparameter."
        )

    dev = resolve_device(device)
    train_dmatrix, val_dmatrix, train_val_dmatrix = get_validated_data_matrices(
        train_path, val_path, file_type, csv_weights, is_pipe,
    )
    missing_validation_data = validation_channel and not val_dmatrix

    if num_hosts == 1:
        if train_dmatrix:
            if missing_validation_data:
                raise exc.UserError("No data in validation channel path {}".format(val_path))
            logger.info("Single node training.")
            train_job(
                train_cfg=validated_train_config,
                train_dmatrix=train_dmatrix,
                val_dmatrix=val_dmatrix,
                train_val_dmatrix=train_val_dmatrix,
                model_dir=model_dir,
                checkpoint_dir=checkpoint_dir,
                is_master=True,
                device=dev,
            )
        else:
            raise exc.UserError("No data in training channel path {}".format(train_path))
    else:
        raise exc.PlatformError("Number of hosts should be an int greater than or equal to 1")


def train_job(
    train_cfg, train_dmatrix, val_dmatrix, train_val_dmatrix, model_dir, checkpoint_dir,
    is_master, device=None,
):
    """Run boosting on this node on ``device``; save the model (master only)."""
    train_cfg = dict(train_cfg)
    train_cfg.pop("_num_devices", None)
    if "_kfold" in train_cfg:
        raise exc.UserError(
            "k-fold cross-validation (_kfold) is not supported by the PyTorch port yet"
        )
    num_round = train_cfg.pop("num_round")
    save_model_on_termination = train_cfg.pop("save_model_on_termination", "false")

    tuning_objective_metric_param = train_cfg.pop("_tuning_objective_metric", None)
    eval_metric = train_cfg.get("eval_metric")
    cleaned_eval_metric, _feval, tuning_objective_metric = (
        train_utils.get_eval_metrics_and_feval(tuning_objective_metric_param, eval_metric)
    )
    if cleaned_eval_metric:
        train_cfg["eval_metric"] = cleaned_eval_metric
    else:
        train_cfg.pop("eval_metric", None)

    early_stopping_rounds = train_cfg.pop("early_stopping_rounds", None)
    early_stopping_data_name = "validation" if val_dmatrix else None
    early_stopping_metric = None
    if early_stopping_rounds:
        if tuning_objective_metric:
            early_stopping_metric = tuning_objective_metric[-1]
        elif eval_metric:
            early_stopping_metric = eval_metric[-1]

    logger.info(
        "Train matrix has %d rows and %d columns",
        train_dmatrix.num_row,
        train_dmatrix.num_col,
    )
    if val_dmatrix:
        logger.info("Validation matrix has %d rows", val_dmatrix.num_row)

    try:
        watchlist = [(train_dmatrix, "train")]
        if val_dmatrix is not None:
            watchlist.append((val_dmatrix, "validation"))
        xgb_model, iteration, callbacks = get_callbacks(
            model_dir=model_dir,
            checkpoint_dir=checkpoint_dir,
            early_stopping_data_name=early_stopping_data_name,
            early_stopping_metric=early_stopping_metric,
            early_stopping_rounds=early_stopping_rounds,
            save_model_on_termination=save_model_on_termination,
            is_master=is_master,
            num_round=num_round,
        )
        bst = booster.train(
            train_cfg,
            train_dmatrix,
            num_boost_round=num_round - iteration,
            evals=watchlist,
            device=device,
            callbacks=callbacks,
            verbose_eval=False,
            xgb_model=xgb_model,
        )
    except Exception as e:
        for customer_error_message in CUSTOMER_ERRORS:
            if customer_error_message in str(e):
                raise exc.UserError(str(e))
        if isinstance(e, (exc.UserError, exc.PlatformError)):
            raise
        raise exc.AlgorithmError("XGB train call failed with exception:\n {}".format(e))

    os.makedirs(model_dir, exist_ok=True)
    if is_master:
        model_location = os.path.join(model_dir, MODEL_NAME)
        bst.save_model(model_location)
        logger.debug("Stored trained model at %s", model_location)
    return bst
