"""The ``train`` entry point: algorithm mode on the SageMaker filesystem contract.

    python -m sagemaker_xgboost_container_tpu_torch.training.entry

The port's counterpart of ``sagemaker_xgboost_container_tpu/training/entry.py``.
Algorithm mode reads the SM_* env variables (or derives them from the
mounted /opt/ml tree), which point at the JSON config files and the channel
directories, and calls ``sagemaker_train`` on the GPU. Script mode
(``sagemaker_program`` in the hyperparameters, or ``SAGEMAKER_PROGRAM``)
runs the user's script from ``sagemaker_submit_directory`` (a directory, or
a .tar.gz extracted into /opt/ml/code) as a subprocess with the SM
environment, after pip-installing its requirements.txt. A failure writes
its message to the failure file (``$SM_OUTPUT_DIR/failure``, by default
``/opt/ml/output/failure``) and exits 1.
"""

import json
import logging
import os
import subprocess
import sys
import tarfile

from .. import constants
from ..toolkit import exceptions as exc
from .algorithm_train import sagemaker_train

logger = logging.getLogger(__name__)

FAILURE_FILE = "/opt/ml/output/failure"
SM_INPUT_ROOT = "/opt/ml/input"
CODE_DIR = "/opt/ml/code"


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


def _stage_user_module(hyperparameters, code_dir=CODE_DIR):
    """The directory holding the user's code: ``sagemaker_submit_directory``
    itself when it is a directory, or ``code_dir`` with the .tar.gz it names
    extracted there (the "data" filter: no absolute paths, no links out of
    ``code_dir``). None when no submit directory is given."""
    submit_dir = hyperparameters.get("sagemaker_submit_directory")
    if not submit_dir:
        return None
    if os.path.isdir(submit_dir):
        return submit_dir
    if submit_dir.endswith(".tar.gz") and os.path.exists(submit_dir):
        os.makedirs(code_dir, exist_ok=True)
        with tarfile.open(submit_dir) as tar:
            tar.extractall(code_dir, filter="data")
        return code_dir
    raise exc.UserError(
        "sagemaker_submit_directory {} not found locally; S3 download is the "
        "platform's responsibility".format(submit_dir)
    )


def run_script_mode(code_dir=CODE_DIR):
    """Run the user's training script as a subprocess in its code
    directory: its requirements.txt installed first, the hyperparameters
    (without the sagemaker_* keys) as ``SM_HPS`` JSON and as ``--key value``
    arguments in sorted order, ``SM_MODEL_DIR`` set. A missing script or a
    non-zero exit raises UserError."""
    train_config = _read_json(os.getenv(constants.SM_INPUT_TRAINING_CONFIG_FILE))
    program = train_config.get("sagemaker_program") or os.environ.get("SAGEMAKER_PROGRAM")
    code_dir = _stage_user_module(train_config, code_dir) or os.environ.get(
        "SAGEMAKER_SUBMIT_DIRECTORY", code_dir)
    script = os.path.join(code_dir, program)
    if not os.path.exists(script):
        raise exc.UserError("User entry point {} does not exist".format(script))
    from ..utils.requirements import install_requirements_if_present

    install_requirements_if_present(code_dir)
    env = dict(os.environ)
    hps = {k: v for k, v in train_config.items() if not k.startswith("sagemaker_")}
    env["SM_HPS"] = json.dumps(hps)
    env.setdefault("SM_MODEL_DIR", os.getenv(constants.SM_MODEL_DIR, "/opt/ml/model"))
    args = [sys.executable, script]
    for key, value in sorted(hps.items()):
        args.extend(["--{}".format(key), str(value)])
    logger.info("Invoking user training script: %s", " ".join(args))
    result = subprocess.run(args, env=env, cwd=code_dir)
    if result.returncode != 0:
        raise exc.UserError(
            "User script exited with non-zero status {}".format(result.returncode))


def train(device=None):
    """Script mode when a program is named, else algorithm mode on
    ``device`` (the user's script picks its own device)."""
    train_config = _read_json(os.getenv(constants.SM_INPUT_TRAINING_CONFIG_FILE))
    if train_config.get("sagemaker_program") or os.environ.get("SAGEMAKER_PROGRAM"):
        logger.info("Invoking user training script.")
        run_script_mode()
    else:
        logger.info("Running XGBoost Sagemaker in algorithm mode")
        run_algorithm_mode(device=device)


def _failure_file():
    # graftlint: disable=capture-env-read not captured: reached from the round only
    # through a failed collective's abort (across ranks, which run eagerly) or the
    # kernels' first build (the eager warm-up round)
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


def local_rank_main(local_rank, spec, parent_pid, err_path):
    """The entry of a spawned local rank (``parallel/local.py``): it dies
    with its leader, arms its own fault spec (``SM_LOCAL_FAULT_SPEC``),
    trains its shard (``algorithm_train.run_local_rank``) and exits 0, or
    writes its error text to ``err_path``, which the leader puts in the
    host's failure file, and exits 1. It prints no metric lines."""
    from ..parallel import local
    from ..utils import faults
    from ..utils.logging_config import setup_main_logger

    local.die_with_parent(parent_pid)
    setup_main_logger(__name__)
    spec_text = local.local_fault_spec(local_rank)
    if spec_text is not None:
        faults.configure(spec_text)
    try:
        from .algorithm_train import run_local_rank

        run_local_rank(local_rank, spec)
    except BaseException as e:
        logger.exception("local rank %d failed", local_rank)
        if isinstance(e, exc.BaseToolkitError):
            message = e.public_failure_message()
        else:
            message = exc.convert_to_algorithm_error(e).public_failure_message()
        try:
            with open(err_path, "w") as f:
                f.write(message)
        except OSError:
            pass
        os._exit(1)
    os._exit(0)


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
