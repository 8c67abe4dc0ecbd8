"""Transient-I/O retries (``utils/retry.py``), the warn-once guard and the
readers' retry wiring, held against the JAX package with the same ``rng``
and ``sleep`` stubs: the same delays (exactly), the same counter deltas and
the same give-up."""

import logging
import os

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data import readers as jax_readers
from sagemaker_xgboost_container_tpu.telemetry import REGISTRY as JAX_REGISTRY
from sagemaker_xgboost_container_tpu.utils import faults as jax_faults
from sagemaker_xgboost_container_tpu.utils import retry as jax_retry
from sagemaker_xgboost_container_tpu.utils import warn_once as jax_warn_once
from sagemaker_xgboost_container_tpu_torch.data import readers
from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.utils import faults, retry, warn_once

PACKAGES = {"port": (retry, REGISTRY), "jax": (jax_retry, JAX_REGISTRY)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in (retry.RETRY_ATTEMPTS_ENV, retry.RETRY_BACKOFF_ENV, faults.FAULT_SPEC_ENV):
        monkeypatch.delenv(knob, raising=False)
    for mod in (faults, jax_faults):
        mod.reset()
    for mod in (retry, jax_retry):
        mod.reset_warnings()
    yield
    for mod in (faults, jax_faults):
        mod.reset()


def _count(registry, name, site):
    for metric_name, _kind, _help, series in registry.collect():
        if metric_name == name:
            for m in series:
                if m.labels == {"site": site}:
                    return m.value
    return 0.0


def _run(pkg, fails, attempts, backoff, site):
    """Retry a callable that raises OSError ``fails`` times -> (result or
    the exception's type, the sleeps, retries counted, give-ups counted)."""
    mod, registry = PACKAGES[pkg]
    draws = iter([0.0, 0.25, 0.5, 0.75, 1.0, 0.1, 0.9] * 3)
    sleeps, calls = [], []
    before = (_count(registry, "io_retries_total", site),
              _count(registry, "io_retry_exhausted_total", site))

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise OSError("blip {}".format(len(calls)))
        return "ok"

    try:
        result = mod.retry_transient(fn, site=site, attempts=attempts, backoff_s=backoff,
                                     sleep=sleeps.append, rng=lambda: next(draws))
    except OSError as e:
        result = ("raised", str(e))
    return (result, sleeps, len(calls),
            _count(registry, "io_retries_total", site) - before[0],
            _count(registry, "io_retry_exhausted_total", site) - before[1])


@pytest.mark.parametrize("fails,attempts,backoff", [
    (0, 3, 0.1), (1, 3, 0.1), (2, 3, 0.1), (3, 3, 0.1), (5, 6, 0.05), (1, 1, 0.1),
    (2, 4, 0.0)])
def test_retry_jitter_counters_and_give_up_match_jax(fails, attempts, backoff):
    site = "test.site.{}.{}".format(fails, attempts)
    ours = _run("port", fails, attempts, backoff, site)
    ref = _run("jax", fails, attempts, backoff, site)
    assert ours == ref
    result, sleeps, calls, retries, exhausted = ours
    assert calls == min(fails + 1, attempts)
    assert retries == len(sleeps) if backoff > 0 else retries == calls - 1 - exhausted
    assert exhausted == (1 if fails >= attempts else 0)
    assert (result == "ok") == (fails < attempts)
    for k, delay in enumerate(sleeps):
        # half-to-full jitter of base * 2^k
        assert backoff * 2 ** k * 0.5 <= delay <= backoff * 2 ** k


@pytest.mark.parametrize("attempts,backoff", [
    ("0", "-1"), ("50", "100"), ("abc", "x"), ("5", "0.2"), ("1", "30"), (None, None)])
def test_retry_knobs_match_jax(monkeypatch, attempts, backoff):
    for name, value in ((retry.RETRY_ATTEMPTS_ENV, attempts), (retry.RETRY_BACKOFF_ENV, backoff)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert retry.retry_attempts() == jax_retry.retry_attempts()
    assert retry.retry_backoff_s() == jax_retry.retry_backoff_s()
    assert 1 <= retry.retry_attempts() <= 20 and 0.0 <= retry.retry_backoff_s() <= 30.0


def test_semantic_errors_propagate_at_once():
    calls = []

    def fn():
        calls.append(1)
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        retry.retry_transient(fn, site="test.semantic", attempts=5, sleep=lambda s: None)
    assert calls == [1]


def test_warn_once_per_site_and_key(caplog):
    with caplog.at_level(logging.WARNING):
        for _ in range(3):
            retry.retry_transient(_fail_once(), site="test.warn", attempts=2,
                                  sleep=lambda s: None, rng=lambda: 0.0)
    warned = [r for r in caplog.records if "test.warn" in r.getMessage()]
    assert len(warned) == 1
    log = logging.getLogger("test_torch_retry")
    warn_once.reset_warnings()
    jax_warn_once.reset_warnings()
    got = [warn_once.warn_once(log, "k", "m %s", 1) for _ in range(2)]
    want = [jax_warn_once.warn_once(log, "k", "m %s", 1) for _ in range(2)]
    assert got == want == [True, False]
    warn_once.reset_warnings()
    assert warn_once.warn_once(log, "k", "m") is True


def _fail_once():
    state = []

    def fn():
        if not state:
            state.append(1)
            raise OSError("blip")
        return 1
    return fn


# ------------------------------------------------------------------ readers
def _channel(path, fmt, n=60, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.rand(n, 3), 4).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "part-0"), "w") as f:
        for label, row in zip(y, X):
            if fmt == "csv":
                f.write(",".join(repr(float(v)) for v in [label, *row]) + "\n")
            else:
                f.write("{} {}\n".format(float(label), " ".join(
                    "{}:{}".format(j, float(v)) for j, v in enumerate(row))))
    return X, y


@pytest.mark.parametrize("fmt,content_type", [("csv", "text/csv"), ("libsvm", "text/libsvm")])
def test_reader_absorbs_one_transient_read_like_jax(tmp_path, monkeypatch, fmt, content_type):
    """``data.read:error@1``: the first read of the channel fails, the
    retry reads it; both packages count one retry at their site and read
    the same matrix as without the fault."""
    data = str(tmp_path / "data")
    X, y = _channel(data, fmt)
    real_stage = jax_readers.stage_input_files
    monkeypatch.setattr(jax_readers, "stage_input_files",
                        lambda p: real_stage(p, staging_dir=str(tmp_path / "jax_stage")))
    site = "reader.csv" if fmt == "csv" else "reader.libsvm"
    clean = readers.get_data_matrix(data, content_type)
    got = {}
    for name, mod, flt, registry in (("port", readers, faults, REGISTRY),
                                     ("jax", jax_readers, jax_faults, JAX_REGISTRY)):
        before = _count(registry, "io_retries_total", site)
        flt.configure("data.read:error:simulated blip@1")
        dm = mod.get_data_matrix(data, content_type)
        assert flt.fault_counts()["data.read"] == 1
        assert _count(registry, "io_retries_total", site) - before == 1
        got[name] = dm
        flt.reset()
    np.testing.assert_array_equal(got["port"].features, clean.features)
    np.testing.assert_array_equal(got["port"].features, got["jax"].features)
    np.testing.assert_array_equal(got["port"].get_label(), got["jax"].get_label())


def test_reader_gives_up_after_the_budget(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    _channel(data, "csv")
    monkeypatch.setenv(retry.RETRY_ATTEMPTS_ENV, "2")
    monkeypatch.setenv(retry.RETRY_BACKOFF_ENV, "0")
    faults.configure("data.read:error:down")
    with pytest.raises(exc.UserError, match="Failed to load"):
        readers.get_data_matrix(data, "text/csv")
    assert faults.fault_counts()["data.read"] == 2


def test_empty_files_warn_once_and_count_once(tmp_path, caplog):
    data = tmp_path / "data"
    _channel(str(data), "csv")
    (data / "empty-1").write_text("")
    before = _count_plain(REGISTRY, "ingest_files_empty_total")
    warn_once.reset_warnings()
    with caplog.at_level(logging.WARNING):
        readers.validate_data_file_path(str(data), "text/csv")
        readers.get_data_matrix(str(data), "text/csv")
        readers.get_data_matrix(str(data), "text/csv")
    assert _count_plain(REGISTRY, "ingest_files_empty_total") - before == 2
    assert len([r for r in caplog.records if "zero-byte" in r.getMessage()]) == 1


def _count_plain(registry, name):
    for metric_name, _kind, _help, series in registry.collect():
        if metric_name == name:
            return sum(m.value for m in series)
    return 0.0
