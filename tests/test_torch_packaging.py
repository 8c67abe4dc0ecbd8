"""The port's packaging: where it caches what it builds
(``utils/compile_cache``, ``GRAFT_COMPILE_CACHE_DIR``), how its native
library is found (shipped or built), its dependency contract
(``version_contract.py``), what ``setup.py`` declares for it beside the JAX
package, and its CreateAlgorithm metadata against the JAX package's."""

import logging
import os
import runpy
import shutil
import subprocess
import sys

import pytest
import setuptools

from sagemaker_xgboost_container_tpu import version_contract as jax_contract
from sagemaker_xgboost_container_tpu.toolkit import metadata as jax_metadata
from sagemaker_xgboost_container_tpu_torch import _build
from sagemaker_xgboost_container_tpu_torch import version_contract as contract
from sagemaker_xgboost_container_tpu_torch.data import native
from sagemaker_xgboost_container_tpu_torch.toolkit import metadata
from sagemaker_xgboost_container_tpu_torch.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOB = compile_cache.COMPILE_CACHE_ENV


@pytest.fixture
def fresh_cache(monkeypatch):
    """Resolve the compile cache (and load the native library) anew in the
    test, and again after it."""
    monkeypatch.delenv(KNOB, raising=False)
    compile_cache._reset_for_tests()
    native._reset_for_tests()
    yield
    compile_cache._reset_for_tests()
    native._reset_for_tests()


# ------------------------------------------------------- the compile cache

def test_cache_unset_is_build_beside_the_package(fresh_cache):
    assert compile_cache.maybe_enable_compile_cache() is None
    assert compile_cache.DEFAULT_ROOT == os.path.join(REPO, "build")
    assert _build.build_dir() == os.path.join(REPO, "build", "torch_kernels")
    assert native.cache_dir() == os.path.join(REPO, "build", "torch_native")


def test_cache_knob_moves_both_libraries(fresh_cache, monkeypatch, tmp_path):
    """With the knob set, the kernels' and the native library's caches are
    under it, and the native library builds there."""
    root = tmp_path / "cache"
    monkeypatch.setenv(KNOB, str(root))
    assert compile_cache.maybe_enable_compile_cache() == str(root)
    assert _build.build_dir() == str(root / "torch_kernels")
    assert native.cache_dir() == str(root / "torch_native")
    monkeypatch.setattr(native, "_packaged_extension", lambda: None)
    assert native.native_available()
    info = native.load_info()
    assert info["route"] == "built" and info["build_s"] > 0
    assert info["path"].startswith(str(root / "torch_native") + os.sep)
    # a second process finds it: the same key, no build
    native._reset_for_tests()
    assert native.load_info() == dict(info, route="cached", build_s=0.0)


def test_cache_unusable_dir_warns_and_uses_the_default(fresh_cache, monkeypatch, tmp_path,
                                                         caplog):
    blocker = tmp_path / "a-file"
    blocker.write_text("x")
    monkeypatch.setenv(KNOB, str(blocker / "cache"))
    with caplog.at_level(logging.WARNING, logger=compile_cache.__name__):
        assert compile_cache.maybe_enable_compile_cache() is None
    assert _build.build_dir() == os.path.join(compile_cache.DEFAULT_ROOT, "torch_kernels")
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and KNOB in warnings[0].getMessage()


def test_cache_is_resolved_once_a_process(fresh_cache, monkeypatch, tmp_path):
    monkeypatch.setenv(KNOB, str(tmp_path / "first"))
    first = compile_cache.maybe_enable_compile_cache()
    monkeypatch.setenv(KNOB, str(tmp_path / "second"))
    assert compile_cache.maybe_enable_compile_cache() == first == str(tmp_path / "first")
    monkeypatch.delenv(KNOB)
    assert _build.build_dir() == os.path.join(first, "torch_kernels")
    assert not (tmp_path / "second").exists()


# --------------------------------------------------- the native library

def test_resolve_lib_path_branches(monkeypatch, tmp_path):
    """The shipped ``_fastdata*.so`` wins where there is no source or the
    source is older; a newer source rebuilds (the JAX package's rule)."""
    shipped = tmp_path / "_fastdata.cpython-312.so"
    shipped.write_bytes(b"x")
    source = tmp_path / "fastdata.cpp"
    monkeypatch.setattr(native, "_packaged_extension", lambda: str(shipped))
    monkeypatch.setattr(native, "_SOURCE", str(tmp_path / "missing.cpp"))
    assert native._resolve_lib_path() == ("packaged", str(shipped))
    source.write_text("// old")
    os.utime(source, (1, 1))
    monkeypatch.setattr(native, "_SOURCE", str(source))
    assert native._resolve_lib_path() == ("packaged", str(shipped))
    os.utime(source, None)
    os.utime(shipped, (1, 1))
    assert native._resolve_lib_path() == ("rebuild", None)
    monkeypatch.setattr(native, "_packaged_extension", lambda: None)
    assert native._resolve_lib_path() == ("rebuild", None)


def test_shipped_library_in_the_package_is_loaded(fresh_cache, monkeypatch, tmp_path):
    """A ``_fastdata*.so`` in the port's package directory (what
    ``setup.py`` ships) loads without a compiler."""
    built = native.load_info()["path"]
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    shutil.copy(built, pkg / "_fastdata.cpython-312-x86_64-linux-gnu.so")
    native._reset_for_tests()
    monkeypatch.setattr(native, "_PKG_DIR", str(pkg))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_SOURCE", str(tmp_path / "no-source.cpp"))
    info = native.load_info()
    assert info["route"] == "packaged" and info["path"].startswith(str(pkg))
    assert native.parse_libsvm_native("1 0:2\n")[1].tolist() == [1.0]


def test_no_compiler_falls_back_with_one_warning(fresh_cache, monkeypatch, caplog):
    monkeypatch.setattr(native, "_packaged_extension", lambda: None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.native_available()
        assert not native.forest_predictor_available()
        assert native.parse_libsvm_native("1 0:2\n") is None
    assert native.load_info() == {}
    assert len([r for r in caplog.records if r.levelno == logging.WARNING]) == 1


# ------------------------------------------------- the version contract

def test_contract_loads_by_path_without_dependencies():
    ns = runpy.run_path(contract.__file__.replace(".pyc", ".py"))
    assert callable(ns["install_requires"])
    assert ns["SUPPORTED"] == contract.SUPPORTED


def test_contract_names_what_the_port_imports():
    assert "jax" not in contract.SUPPORTED
    assert {"torch", "numpy", "scipy", "packaging"} <= set(contract.SUPPORTED)
    assert contract.install_requires() == sorted(
        name + spec for name, spec in contract.SUPPORTED.items())
    assert contract.violations() == []


@pytest.mark.parametrize("version,ok", [
    ("2.13.0+cpu", True), ("2.11.0+cu128", True), ("2.4.0", True), ("2.3.1", False)])
def test_contract_torch_floor(monkeypatch, version, ok):
    import importlib.metadata as md

    real = md.version
    monkeypatch.setattr(md, "version", lambda name: version if name == "torch" else real(name))
    assert (contract.violations() == []) == ok


def test_contract_cli_exits_0_here():
    out = subprocess.run(
        [sys.executable, "-m", "sagemaker_xgboost_container_tpu_torch.version_contract"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "dependency contract OK" in out.stdout


def test_contract_reports_violations(monkeypatch):
    monkeypatch.setitem(contract.SUPPORTED, "numpy", ">=999.0")
    monkeypatch.setitem(contract.SUPPORTED, "definitely-not-installed-xyz", ">=1.0")
    bad = dict((n, v) for n, v, _s in contract.violations())
    assert "numpy" in bad and bad["definitely-not-installed-xyz"] is None
    with pytest.raises(RuntimeError, match="dependency contract violated"):
        contract.assert_supported()


# ----------------------------------------------------------- setup.py

@pytest.fixture(scope="module")
def setup_kwargs():
    seen = {}
    real = setuptools.setup
    setuptools.setup = lambda **kw: seen.update(kw)
    try:
        runpy.run_path(os.path.join(REPO, "setup.py"), run_name="__main__")
    finally:
        setuptools.setup = real
    return seen


def test_setup_keeps_the_jax_package_as_it_was(setup_kwargs):
    assert setup_kwargs["name"] == "sagemaker_xgboost_container_tpu"
    assert setup_kwargs["install_requires"] == jax_contract.install_requires()
    scripts = setup_kwargs["entry_points"]["console_scripts"]
    assert "train=sagemaker_xgboost_container_tpu.training.entry:main" in scripts
    assert "serve=sagemaker_xgboost_container_tpu.serving.server:main" in scripts
    (jax_ext,) = [e for e in setup_kwargs["ext_modules"]
                  if e.name == "sagemaker_xgboost_container_tpu._fastdata"]
    assert jax_ext.sources == ["native/fastdata.cpp"] and jax_ext.optional


def test_setup_declares_the_port(setup_kwargs):
    (ext,) = [e for e in setup_kwargs["ext_modules"]
              if e.name == "sagemaker_xgboost_container_tpu_torch._fastdata"]
    assert ext.sources == ["native/fastdata.cpp"] and ext.optional
    assert setup_kwargs["extras_require"] == {"torch": contract.install_requires()}
    scripts = dict(s.split("=", 1) for s in setup_kwargs["entry_points"]["console_scripts"])
    assert scripts["train-torch"] == "sagemaker_xgboost_container_tpu_torch.training.entry:main"
    assert scripts["serve-torch"] == "sagemaker_xgboost_container_tpu_torch.serving.server:main"
    import importlib

    for name in ("train-torch", "serve-torch"):
        module, attr = scripts[name].split(":")
        assert callable(getattr(importlib.import_module(module), attr))
    assert "csrc/*.cu" in setup_kwargs["package_data"]["sagemaker_xgboost_container_tpu_torch"]


# ----------------------------------------------------------- metadata

def test_algorithm_spec_matches_jax_but_the_instances():
    ours = metadata.generate_algorithm_spec("image:1")
    theirs = jax_metadata.generate_algorithm_spec("image:1")
    assert ours.keys() == theirs.keys()
    for spec in ours:
        assert ours[spec].keys() == theirs[spec].keys()
    tr, jtr = ours["TrainingSpecification"], theirs["TrainingSpecification"]
    for key in ("TrainingImage", "TrainingChannels", "SupportedHyperParameters",
                "SupportsDistributedTraining", "MetricDefinitions",
                "SupportedTuningJobObjectiveMetrics"):
        assert tr[key] == jtr[key], key
    assert [h["Name"] for h in tr["SupportedHyperParameters"]] == \
        [h["Name"] for h in jtr["SupportedHyperParameters"]]
    inf, jinf = ours["InferenceSpecification"], theirs["InferenceSpecification"]
    for key in ("Containers", "SupportedContentTypes", "SupportedResponseMIMETypes",
                "SupportedInferenceModes"):
        assert inf[key] == jinf[key], key
    assert tr["SupportedTrainingInstanceTypes"] == ["ml.p5.48xlarge"]
    assert inf["SupportedRealtimeInferenceInstanceTypes"] == ["ml.p5.48xlarge"]


def test_instance_fetcher_and_its_fallback():
    assert metadata.fetch_instance_types(None, ["a"]) == ["a"]
    assert metadata.fetch_instance_types(lambda: ["b", "c"], ["a"]) == ["b", "c"]
    assert metadata.fetch_instance_types(lambda: [], ["a"]) == ["a"]

    def broken():
        raise RuntimeError("no network")

    assert metadata.fetch_instance_types(broken, ["a"]) == ["a"]
    spec = metadata.generate_algorithm_spec("img", instance_type_fetcher=lambda: ["ml.x"])
    assert spec["TrainingSpecification"]["SupportedTrainingInstanceTypes"] == ["ml.x"]
    assert spec["InferenceSpecification"]["SupportedTransformInstanceTypes"] == ["ml.x"]
