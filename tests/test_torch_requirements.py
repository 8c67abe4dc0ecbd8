"""Script-mode serving installs the script's ``requirements.txt`` before it
imports the script, as the JAX package's loader does; pip is stubbed (no
network here)."""

import subprocess
import sys

import pytest

from sagemaker_xgboost_container_tpu.toolkit import exceptions as jax_exc
from sagemaker_xgboost_container_tpu.utils import requirements as jax_requirements
from sagemaker_xgboost_container_tpu_torch.serving import server
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.utils import requirements


def _script_dir(tmp_path):
    """A script that refuses to import unless the install has run."""
    (tmp_path / "requirements.txt").write_text("some-extra-package\n")
    (tmp_path / "inference.py").write_text(
        "import os\n"
        "if not os.path.exists(os.path.join(os.path.dirname(__file__), 'installed')):\n"
        "    raise ImportError('requirements.txt was not installed first')\n"
        "def transform_fn(model, payload, content_type, accept):\n"
        "    return b'ok', 'text/plain'\n")
    return tmp_path


def test_install_runs_before_the_script_is_imported(tmp_path, monkeypatch):
    code = _script_dir(tmp_path)
    calls = []

    def fake_check_call(cmd):
        calls.append(list(cmd))
        (code / "installed").write_text("")

    monkeypatch.setattr(requirements.subprocess, "check_call", fake_check_call)
    monkeypatch.setenv("SAGEMAKER_PROGRAM", "inference.py")
    monkeypatch.setenv("SAGEMAKER_SUBMIT_DIRECTORY", str(code))
    hooks = server._load_user_hooks(str(tmp_path / "model"))
    assert sorted(hooks) == ["transform_fn"]
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[:5] == [sys.executable, "-m", "pip", "install", "-r"]
    assert cmd[5] == str(code / "requirements.txt")


def test_no_requirements_file_installs_nothing(tmp_path, monkeypatch):
    (tmp_path / "inference.py").write_text("def predict_fn(data, model):\n    return data\n")
    monkeypatch.setattr(requirements.subprocess, "check_call",
                        lambda cmd: pytest.fail("pip ran without a requirements.txt"))
    monkeypatch.setenv("SAGEMAKER_PROGRAM", "inference.py")
    monkeypatch.setenv("SAGEMAKER_SUBMIT_DIRECTORY", str(tmp_path))
    assert sorted(server._load_user_hooks(str(tmp_path))) == ["predict_fn"]
    assert requirements.install_requirements_if_present(str(tmp_path)) is False


@pytest.mark.parametrize("package", ["port", "jax"])
def test_pip_failure_raises_a_user_error(package, tmp_path, monkeypatch):
    """Both packages turn a failed pip into their UserError naming the file,
    and the port's loader does not import the script after it."""
    mod, user_error = ((requirements, exc.UserError) if package == "port"
                       else (jax_requirements, jax_exc.UserError))
    code = _script_dir(tmp_path)

    def failing(cmd):
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(mod.subprocess, "check_call", failing)
    with pytest.raises(user_error) as err:
        mod.install_requirements_if_present(str(code))
    assert "Failed to install packages from the user module's requirements.txt" in str(err.value)
    assert str(code / "requirements.txt") in str(err.value)
    if package == "port":
        monkeypatch.setenv("SAGEMAKER_PROGRAM", "inference.py")
        monkeypatch.setenv("SAGEMAKER_SUBMIT_DIRECTORY", str(code))
        with pytest.raises(exc.UserError):
            server._load_user_hooks(str(tmp_path))
        assert not any(name.startswith("user_inference_") and
                       getattr(m, "__file__", "") == str(code / "inference.py")
                       for name, m in list(sys.modules.items()))


def test_constraints_pin_the_ports_runtime(tmp_path, monkeypatch):
    """The constraints file pins torch and numpy, never jax; a version with
    a local build label ('+cu124') stays unpinned, as in the JAX package."""
    import importlib.metadata as md

    versions = {"torch": "2.5.1", "numpy": "2.1.0", "scipy": "1.14.1+local"}

    def version(pkg):
        if pkg not in versions:
            raise md.PackageNotFoundError(pkg)
        return versions[pkg]

    monkeypatch.setattr(md, "version", version)
    (tmp_path / "requirements.txt").write_text("some-extra-package\n")
    seen = {}

    def fake_check_call(cmd):
        seen["cmd"] = list(cmd)
        if "-c" in cmd:
            seen["pins"] = open(cmd[cmd.index("-c") + 1]).read().split()

    monkeypatch.setattr(requirements.subprocess, "check_call", fake_check_call)
    assert requirements.install_requirements_if_present(str(tmp_path)) is True
    assert seen["pins"] == ["torch==2.5.1", "numpy==2.1.0"]
    assert not any(p.startswith(("jax", "libtpu")) for p in requirements.FRAMEWORK_CRITICAL)
    monkeypatch.setenv("GRAFT_PIP_NO_CONSTRAINTS", "1")
    assert requirements.install_requirements_if_present(str(tmp_path)) is True
    assert "-c" not in seen["cmd"]
