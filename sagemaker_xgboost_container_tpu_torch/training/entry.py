"""The ``train`` entry point: algorithm mode on the SageMaker filesystem contract.

    python -m sagemaker_xgboost_container_tpu_torch.training.entry

The port's counterpart of ``sagemaker_xgboost_container_tpu/training/entry.py``.
Algorithm mode reads the SM_* env variables (or derives them from the
mounted /opt/ml tree), which point at the JSON config files and the channel
directories, and calls ``sagemaker_train`` on the GPU. A failure writes its
message to the failure file (``$SM_OUTPUT_DIR/failure``, by default
``/opt/ml/output/failure``) and exits 1. Script mode (a user's training
script, ``sagemaker_program``) is not ported yet and raises ``UserError``.
"""

import json
import logging
import os
import sys

from .. import constants
from ..toolkit import exceptions as exc
from .algorithm_train import sagemaker_train

logger = logging.getLogger(__name__)

FAILURE_FILE = "/opt/ml/output/failure"
SM_INPUT_ROOT = "/opt/ml/input"


def _read_json(path, default=None):
    if path and os.path.exists(path):
        with open(path, "r") as f:
            return json.load(f)
    return default if default is not None else {}


def derive_sm_env(input_root=SM_INPUT_ROOT):
    """Fill missing SM_* env vars from the mounted /opt/ml tree (explicitly
    set env always wins)."""
    cfg = os.path.join(input_root, "config")
    defaults = {
        constants.SM_INPUT_TRAINING_CONFIG_FILE: os.path.join(cfg, "hyperparameters.json"),
        constants.SM_INPUT_DATA_CONFIG_FILE: os.path.join(cfg, "inputdataconfig.json"),
        constants.SM_CHECKPOINT_CONFIG_FILE: os.path.join(cfg, "checkpointconfig.json"),
        constants.SM_MODEL_DIR: "/opt/ml/model",
        constants.SM_OUTPUT_DATA_DIR: "/opt/ml/output/data",
    }
    for key, path in defaults.items():
        os.environ.setdefault(key, path)
    data_root = os.path.join(input_root, "data")
    if os.path.isdir(data_root):
        for channel in sorted(os.listdir(data_root)):
            channel_dir = os.path.join(data_root, channel)
            if os.path.isdir(channel_dir):
                os.environ.setdefault("SM_CHANNEL_{}".format(channel.upper()), channel_dir)
    resource = _read_json(os.path.join(cfg, "resourceconfig.json"))
    if resource:
        os.environ.setdefault(constants.SM_HOSTS, json.dumps(resource.get("hosts", ["algo-1"])))
        os.environ.setdefault(constants.SM_CURRENT_HOST, resource.get("current_host", "algo-1"))
    else:
        os.environ.setdefault(constants.SM_HOSTS, '["algo-1"]')
        os.environ.setdefault(constants.SM_CURRENT_HOST, "algo-1")


def run_algorithm_mode(device=None):
    """Parse the SM env contract and run algorithm-mode training."""
    train_config = _read_json(os.getenv(constants.SM_INPUT_TRAINING_CONFIG_FILE))
    data_config = _read_json(os.getenv(constants.SM_INPUT_DATA_CONFIG_FILE))
    checkpoint_config = _read_json(os.getenv(constants.SM_CHECKPOINT_CONFIG_FILE))

    train_path = os.environ.get(constants.SM_CHANNEL_TRAIN)
    if not train_path:
        raise exc.UserError(
            "No training data: the 'train' channel is required (mount it at "
            "/opt/ml/input/data/train or set SM_CHANNEL_TRAIN)."
        )
    val_path = os.environ.get(constants.SM_CHANNEL_VALIDATION)
    sm_hosts = json.loads(os.environ[constants.SM_HOSTS])
    sm_current_host = os.environ[constants.SM_CURRENT_HOST]
    model_dir = os.getenv(constants.SM_MODEL_DIR)

    sagemaker_train(
        train_config=train_config,
        data_config=data_config,
        train_path=train_path,
        val_path=val_path,
        model_dir=model_dir,
        sm_hosts=sm_hosts,
        sm_current_host=sm_current_host,
        checkpoint_config=checkpoint_config,
        device=device,
    )


def train(device=None):
    train_config = _read_json(os.getenv(constants.SM_INPUT_TRAINING_CONFIG_FILE))
    if train_config.get("sagemaker_program") or os.environ.get("SAGEMAKER_PROGRAM"):
        raise exc.UserError(
            "script mode (a user training script, sagemaker_program) is not supported "
            "by the PyTorch port yet; run in algorithm mode"
        )
    logger.info("Running XGBoost Sagemaker in algorithm mode")
    run_algorithm_mode(device=device)


def _failure_file():
    output_dir = os.environ.get("SM_OUTPUT_DIR")
    return os.path.join(output_dir, "failure") if output_dir else FAILURE_FILE


def _write_failure_file(message):
    path = _failure_file()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(message)
    except OSError:
        pass


def main(device=None):
    """Run the entry point on ``device`` (CUDA unless given) and exit 0, or
    1 after writing the failure file."""
    from ..utils.logging_config import setup_main_logger

    setup_main_logger(__name__)  # honors SAGEMAKER_CONTAINER_LOG_LEVEL
    try:
        derive_sm_env()
        train(device=device)
    except exc.BaseToolkitError as e:
        logger.exception("Training failed")
        _write_failure_file(e.public_failure_message())
        sys.exit(1)
    except Exception as e:  # unclassified: our bug
        logger.exception("Training failed")
        _write_failure_file(exc.convert_to_algorithm_error(e).public_failure_message())
        sys.exit(1)
    sys.exit(0)


if __name__ == "__main__":
    main()
