"""Script mode of the port's ``train`` entry point
(``training.entry.run_script_mode``) against the JAX package's, on the CPU:
a user script in a submit directory or a .tar.gz, its arguments and
``SM_HPS``, its requirements.txt, a failing script and a missing one."""

import json
import os
import sys
import tarfile

import pytest

from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.training import entry
from sagemaker_xgboost_container_tpu_torch.utils import requirements

# the user script: records what it was given into SM_MODEL_DIR
RECORDER = """
import json, os, sys
os.makedirs(os.environ["SM_MODEL_DIR"], exist_ok=True)
with open(os.path.join(os.environ["SM_MODEL_DIR"], "seen.json"), "w") as f:
    json.dump({"argv": sys.argv[1:], "hps": json.loads(os.environ["SM_HPS"]),
               "cwd": os.getcwd(), "files": sorted(os.listdir("."))}, f)
sys.exit(int(os.environ.get("EXIT_CODE", "0")))
"""

HPS = {"max_depth": "5", "eta": "0.2", "num_round": "10", "alpha": "0"}


def _jax_entry():
    import importlib

    return importlib.import_module("sagemaker_xgboost_container_tpu.training.entry")


def _code(root, files):
    os.makedirs(root, exist_ok=True)
    for name, text in files.items():
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return root


def _env(monkeypatch, tmp_path, hp):
    conf = tmp_path / "hyperparameters.json"
    conf.write_text(json.dumps(hp))
    monkeypatch.setenv("SM_INPUT_TRAINING_CONFIG_FILE", str(conf))
    monkeypatch.setenv("SM_MODEL_DIR", str(tmp_path / "model"))
    monkeypatch.delenv("SAGEMAKER_PROGRAM", raising=False)
    monkeypatch.delenv("SAGEMAKER_SUBMIT_DIRECTORY", raising=False)


def _seen(tmp_path):
    with open(str(tmp_path / "model" / "seen.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("submit", ["directory", "tar.gz"])
def test_script_sees_what_jax_gives_it(submit, tmp_path, monkeypatch):
    """The same arguments (sorted ``--key value``, no sagemaker_* keys),
    SM_HPS, working directory contents and staged files in both packages."""
    src = _code(str(tmp_path / "src"), {"train.py": RECORDER, "lib/helper.py": "X = 1\n"})
    if submit == "tar.gz":
        archive = str(tmp_path / "sourcedir.tar.gz")
        with tarfile.open(archive, "w:gz") as tar:
            for name in ("train.py", "lib/helper.py"):
                tar.add(os.path.join(src, name), arcname=name)
        src = archive
    hp = dict(HPS, sagemaker_program="train.py", sagemaker_submit_directory=src)
    seen = {}
    for package in ("jax", "port"):
        code_dir = str(tmp_path / package / "code")
        (tmp_path / package).mkdir()
        _env(monkeypatch, tmp_path / package, hp)
        if package == "port":
            entry.run_script_mode(code_dir=code_dir)
        else:
            jax_entry = _jax_entry()
            stage = jax_entry._stage_user_module
            monkeypatch.setattr(jax_entry, "_stage_user_module",
                                lambda h: stage(h, code_dir=code_dir))
            jax_entry.run_script_mode()
        seen[package] = _seen(tmp_path / package)
    assert seen["port"]["argv"] == seen["jax"]["argv"] == [
        "--alpha", "0", "--eta", "0.2", "--max_depth", "5", "--num_round", "10"]
    assert seen["port"]["hps"] == seen["jax"]["hps"] == HPS
    assert seen["port"]["files"] == seen["jax"]["files"] == ["lib", "train.py"]
    if submit == "directory":
        assert seen["port"]["cwd"] == seen["jax"]["cwd"] == src
    else:
        assert seen["port"]["cwd"] == str(tmp_path / "port" / "code")


def test_train_dispatches_on_sagemaker_program(tmp_path, monkeypatch):
    """``train()`` runs script mode for ``sagemaker_program`` in the
    hyperparameters, and for ``SAGEMAKER_PROGRAM`` with the code in
    ``SAGEMAKER_SUBMIT_DIRECTORY``."""
    src = _code(str(tmp_path / "src"), {"train.py": RECORDER})
    _env(monkeypatch, tmp_path, dict(HPS, sagemaker_program="train.py",
                                     sagemaker_submit_directory=src))
    entry.train(device="cpu")
    assert _seen(tmp_path)["argv"][:2] == ["--alpha", "0"]
    os.remove(str(tmp_path / "model" / "seen.json"))
    _env(monkeypatch, tmp_path, HPS)
    monkeypatch.setenv("SAGEMAKER_PROGRAM", "train.py")
    monkeypatch.setenv("SAGEMAKER_SUBMIT_DIRECTORY", src)
    entry.train(device="cpu")
    assert _seen(tmp_path)["cwd"] == src


def test_requirements_installed_before_the_script(tmp_path, monkeypatch):
    src = _code(str(tmp_path / "src"), {"train.py": RECORDER, "requirements.txt": "tqdm\n"})
    calls = []

    def check_call(cmd, **kwargs):
        assert not os.path.exists(str(tmp_path / "model" / "seen.json"))
        calls.append(cmd)

    monkeypatch.setattr(requirements.subprocess, "check_call", check_call)
    _env(monkeypatch, tmp_path, dict(HPS, sagemaker_program="train.py",
                                     sagemaker_submit_directory=src))
    entry.run_script_mode(code_dir=str(tmp_path / "code"))
    assert len(calls) == 1 and os.path.join(src, "requirements.txt") in calls[0]
    assert calls[0][:4] == [sys.executable, "-m", "pip", "install"]
    assert _seen(tmp_path)["files"] == ["requirements.txt", "train.py"]


@pytest.mark.parametrize("case", ["non_zero_exit", "missing_script", "missing_submit_dir"])
def test_failures_raise_user_error_as_jax(case, tmp_path, monkeypatch):
    src = _code(str(tmp_path / "src"), {"train.py": RECORDER})
    hp = dict(HPS, sagemaker_program="train.py", sagemaker_submit_directory=src)
    if case == "non_zero_exit":
        monkeypatch.setenv("EXIT_CODE", "3")
    elif case == "missing_script":
        hp["sagemaker_program"] = "nope.py"
    else:
        hp["sagemaker_submit_directory"] = str(tmp_path / "absent.tar.gz")
    _env(monkeypatch, tmp_path, hp)
    jax_entry = _jax_entry()
    stage = jax_entry._stage_user_module
    monkeypatch.setattr(jax_entry, "_stage_user_module",
                        lambda h: stage(h, code_dir=str(tmp_path / "jax_code")))
    with pytest.raises(Exception) as ref:
        jax_entry.run_script_mode()
    with pytest.raises(exc.UserError) as ours:
        entry.run_script_mode(code_dir=str(tmp_path / "code"))
    assert type(ref.value).__name__ == "UserError"
    assert str(ours.value) == str(ref.value).replace(str(tmp_path / "jax_code"),
                                                     str(tmp_path / "code"))
