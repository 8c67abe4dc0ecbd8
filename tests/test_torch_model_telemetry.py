"""The model-quality plane (``telemetry/model.py``, ``SM_MODEL_TELEMETRY``)
held against the JAX package on the CPU, on the same seeded numpy inputs:
tree statistics, drift baselines, bin counts and group maps exact, PSI
within 1e-9, learning records field by field (sums within 1e-5 relative,
counts exact), the numeric-poison drill (exit 87 at the same round), the
EvaluationMonitor contract, and serving drift through both apps."""

import io
import json
import os

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data.binning import bin_matrix as jax_bin_matrix
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.serving import app as jax_app
from sagemaker_xgboost_container_tpu.serving import lifecycle as jax_lifecycle
from sagemaker_xgboost_container_tpu.telemetry import model as jax_model
from sagemaker_xgboost_container_tpu.telemetry import tracing as jax_tracing
from sagemaker_xgboost_container_tpu.training import watchdog as jax_watchdog
from sagemaker_xgboost_container_tpu.training.callbacks import \
    EvaluationMonitor as JaxEvaluationMonitor
from sagemaker_xgboost_container_tpu.training.profiling import RoundTimer as JaxRoundTimer
from sagemaker_xgboost_container_tpu.utils import faults as jax_faults
from sagemaker_xgboost_container_tpu.utils import integrity as jax_integrity
from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.constants import EXIT_NUMERIC_POISON
from sagemaker_xgboost_container_tpu_torch.data.binning import bin_matrix
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.serving import app, lifecycle
from sagemaker_xgboost_container_tpu_torch.telemetry import model as model_telemetry
from sagemaker_xgboost_container_tpu_torch.telemetry import tracing
from sagemaker_xgboost_container_tpu_torch.training import watchdog
from sagemaker_xgboost_container_tpu_torch.training.callbacks import EvaluationMonitor
from sagemaker_xgboost_container_tpu_torch.training.profiling import RoundTimer
from sagemaker_xgboost_container_tpu_torch.utils import faults, integrity

PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 32, "eta": 0.3}
SUM_FIELDS = ("grad_sum", "hess_sum", "split_gain_sum")
COUNT_FIELDS = ("grad_nonfinite", "margin_nonfinite", "trees", "leaves", "max_depth", "round")


def _data(n=2000, d=6, seed=0, missing=0.05):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.randn(n) * 0.5 > 0).astype(np.float32)
    X[rng.rand(n, d) < missing] = np.nan
    return X, y


def _records(out, metric):
    needle = '"metric": "{}"'.format(metric)
    return [json.loads(line) for line in out.splitlines() if needle in line]


@pytest.fixture
def model_env(monkeypatch):
    knobs = (model_telemetry.MODEL_TELEMETRY_ENV, model_telemetry.DRIFT_PSI_MAX_ENV,
             model_telemetry.DRIFT_WINDOW_ENV, model_telemetry.DRIFT_MIN_ROWS_ENV,
             faults.FAULT_SPEC_ENV, tracing.TRACE_EXPORT_DIR_ENV, tracing.TRACE_ENV)
    for knob in knobs:
        monkeypatch.delenv(knob, raising=False)

    def reset():
        for mod in (faults, jax_faults):
            mod.reset()
        for mod in (model_telemetry, jax_model, tracing, jax_tracing):
            mod._reset_for_tests()
        for mod in (watchdog, jax_watchdog):
            mod._reset_abort_for_tests()
        for mod in (lifecycle, jax_lifecycle):
            mod.uninstall()

    reset()
    # a fresh process's XLA compile accounting: an earlier test in this
    # process may have installed the JAX package's jax.monitoring compile
    # listener (its sagemaker_train does), and the JAX rounds' records then
    # carry a "compile" phase that a fresh process's do not
    import jax.monitoring
    from sagemaker_xgboost_container_tpu.telemetry import cluster as jax_cluster

    listener = jax_cluster._on_jax_duration_event
    installed = jax_cluster._compile_listener_installed
    if installed:
        jax.monitoring.unregister_event_duration_listener(listener)
    yield monkeypatch
    if installed:
        jax.monitoring.register_event_duration_secs_listener(listener)
    reset()


def _train_both(X, y, rounds=5, params=PARAMS, **kw):
    """-> (port forest, jax forest, port stdout, jax stdout), each package
    with its own RoundTimer last in the stack."""
    out = {}
    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ours = train(params, DataMatrix(X, y), rounds, device="cpu",
                     callbacks=[RoundTimer()] + kw.get("port_callbacks", []), verbose_eval=False)
    out["port"] = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref = jax_booster.train(params, JaxDataMatrix(X, y), rounds,
                                callbacks=[JaxRoundTimer()] + kw.get("jax_callbacks", []))
    out["jax"] = buf.getvalue()
    return ours, ref, out["port"], out["jax"]


# ------------------------------------------------------ learning, end to end
def test_learning_records_match_jax_field_by_field(model_env):
    model_env.setenv(model_telemetry.MODEL_TELEMETRY_ENV, "true")
    X, y = _data()
    ours, ref, out_port, out_jax = _train_both(X, y)
    for a, b in zip(ours.trees, ref.trees):  # the parity tests' tree-for-tree match
        assert np.array_equal(a.feature, b.feature) and np.array_equal(a.left, b.left)
    got, want = _records(out_port, "training.learning"), _records(out_jax, "training.learning")
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in a:
            if key in COUNT_FIELDS or key == "metric":
                assert a[key] == b[key], key
            elif key in SUM_FIELDS:
                assert abs(a[key] - b[key]) <= 1e-5 * max(1.0, abs(b[key])), key
            else:  # extrema of f32 values, rounded to 6 places
                assert abs(a[key] - b[key]) <= 2e-6 * max(1.0, abs(b[key])), key
    assert model_telemetry.drift_baseline() == jax_model.drift_baseline()
    assert model_telemetry.drift_baseline()["rows"] == len(y)
    rounds = (_records(out_port, "training.round"), _records(out_jax, "training.round"))
    assert len(rounds[0]) == len(rounds[1]) == 5
    for a, b in zip(*rounds):
        assert set(a) == set(b) and set(a["phases_ms"]) == set(b["phases_ms"])
    for metric in ("training.summary", "training.attribution"):
        (a,), (b,) = _records(out_port, metric), _records(out_jax, metric)
        assert set(a) == set(b), metric


def test_trees_bit_identical_with_the_plane_on_and_off(model_env):
    X, y = _data(seed=3)
    off = train(PARAMS, DataMatrix(X, y), 4, device="cpu", verbose_eval=False)
    model_env.setenv(model_telemetry.MODEL_TELEMETRY_ENV, "true")
    on = train(PARAMS, DataMatrix(X, y), 4, device="cpu", verbose_eval=False)
    assert integrity.forest_digest(on) == integrity.forest_digest(off)
    assert model_telemetry.last_learning()["round"] == 3


def test_plane_off_emits_nothing(model_env, capsys):
    X, y = _data(n=400)
    train(PARAMS, DataMatrix(X, y), 3, device="cpu", verbose_eval=False)
    out = capsys.readouterr().out
    assert not _records(out, "training.learning")
    assert model_telemetry.drift_baseline() is None and model_telemetry.last_learning() is None


@pytest.mark.parametrize("booster", ["dart", "gblinear", "update"])
def test_other_boosters_emit_no_learning_records_as_jax(model_env, capsys, booster):
    """dart builds the gbtree session (the baseline is captured) but emits
    no learning record; gblinear and process_type=update neither, in both
    packages."""
    X, y = _data(n=600)
    start = {}
    if booster == "update":
        start = {"port": train(PARAMS, DataMatrix(X, y), 2, device="cpu", verbose_eval=False),
                 "jax": jax_booster.train(PARAMS, JaxDataMatrix(X, y), 2)}
        params = dict(PARAMS, process_type="update", updater="refresh")
    else:
        params = dict(PARAMS, booster=booster, rate_drop=0.2)
    model_env.setenv(model_telemetry.MODEL_TELEMETRY_ENV, "true")
    train(params, DataMatrix(X, y), 2, device="cpu", verbose_eval=False,
          xgb_model=start.get("port"))
    jax_booster.train(params, JaxDataMatrix(X, y), 2, xgb_model=start.get("jax"))
    out = capsys.readouterr().out
    assert not _records(out, "training.learning")
    assert (model_telemetry.drift_baseline() is None) == (jax_model.drift_baseline() is None)
    assert model_telemetry.drift_baseline() == jax_model.drift_baseline()


# ------------------------------------------------------ numeric-poison drill
class _Exited(BaseException):
    pass


@pytest.mark.parametrize("package", ["port", "jax"])
def test_gradient_poison_exits_87_at_round_2(model_env, tmp_path, capsys, package):
    model_env.setenv(model_telemetry.MODEL_TELEMETRY_ENV, "true")
    model_env.setenv(tracing.TRACE_EXPORT_DIR_ENV, str(tmp_path))
    model_env.setenv(faults.FAULT_SPEC_ENV, "train.gradient_poison:nan@3")
    flt, wd = (faults, watchdog) if package == "port" else (jax_faults, jax_watchdog)
    flt.configure_from_env()
    codes = []

    def _exit(code):
        codes.append(code)
        raise _Exited()

    model_env.setattr(wd, "_exit", _exit)
    X, y = _data(n=800)
    with pytest.raises(_Exited):
        if package == "port":
            train(PARAMS, DataMatrix(X, y), 6, device="cpu", verbose_eval=False)
        else:
            jax_booster.train(PARAMS, JaxDataMatrix(X, y), 6)
    out = capsys.readouterr().out
    assert codes == [EXIT_NUMERIC_POISON]
    (abort,) = _records(out, "training.abort")
    assert abort["reason"] == "numeric_poison" and abort["round"] == 2
    path = tmp_path / "learning-forensics-rank0.json"
    assert str(path) == abort["forensics"]
    doc = json.loads(path.read_text())
    assert doc["first_bad_round"] == 2 and doc["reason"] == "numeric_poison"
    history = {row["round"]: row for row in doc["stats_history"]}
    assert history[1]["grad_nonfinite"] == 0 and history[2]["grad_nonfinite"] == 800


def test_first_poisoned_round_matches_jax():
    clean = {"grad_nonfinite": 0.0, "margin_nonfinite": 0.0, "grad_sum": 1.0}
    bad = {"grad_nonfinite": 4.0, "margin_nonfinite": 0.0, "grad_sum": 1.0}
    inf_sum = {"grad_nonfinite": 0.0, "margin_nonfinite": 0.0, "grad_sum": float("inf")}
    for rows, first in (([clean, clean], 10), ([clean, bad], 10), ([inf_sum], 7), ([], 3)):
        assert model_telemetry.first_poisoned_round(rows, first) == \
            jax_model.first_poisoned_round(rows, first)


# --------------------------------------------------- eval monitor contract
def test_eval_lines_byte_identical_and_eval_records_as_jax(model_env, capsys):
    log = {"train": {"logloss": [0.6, 0.5]}, "validation": {"logloss": [0.61, 0.55],
                                                             "auc": [0.7, 0.75]}}
    EvaluationMonitor().after_iteration(None, 1, log)
    off = capsys.readouterr().out
    model_env.setenv(model_telemetry.MODEL_TELEMETRY_ENV, "true")
    EvaluationMonitor().after_iteration(None, 1, log)
    JaxEvaluationMonitor().after_iteration(None, 1, log)
    on = capsys.readouterr().out
    lines = [line for line in on.splitlines() if line.startswith("[")]
    assert lines == [off.strip()] * 2
    got = _records(on, "training.eval")
    assert got[:3] == got[3:] and len(got) == 6
    assert model_telemetry.learning_summary() == jax_model.learning_summary()


def test_learning_summary_matches_jax(model_env):
    rng = np.random.RandomState(4)
    for rnd in range(8):
        for data, metric in (("train", "logloss"), ("validation", "logloss"),
                             ("validation", "auc")):
            value = float(rng.rand())
            model_telemetry.note_eval(rnd, data, metric, value)
            jax_model.note_eval(rnd, data, metric, value)
    assert model_telemetry.learning_summary() == jax_model.learning_summary()
    assert model_telemetry.learning_summary()["metric"] == "auc"


# ------------------------------------------------------------ tree stats
def test_tree_stats_match_jax(model_env):
    X, y = _data(seed=5)
    ours, ref, _out_port, _out_jax = _train_both(X, y, rounds=4)
    for lo in range(4):
        a, b = ours.trees[lo:lo + 1], ref.trees[lo:lo + 1]
        assert model_telemetry.tree_stats(a) == jax_model.tree_stats(a)
        got, want = model_telemetry.tree_stats(a), jax_model.tree_stats(b)
        for key in ("trees", "leaves", "max_depth"):
            assert got[key] == want[key]
        for key in got:
            assert abs(got[key] - want[key]) <= 1e-5 * max(1.0, abs(want[key])), key
    assert model_telemetry.tree_stats(ours.trees) == jax_model.tree_stats(ours.trees)
    assert model_telemetry.tree_stats([]) == jax_model.tree_stats([])


# --------------------------------------------------------------- drift math
@pytest.mark.parametrize("max_bin,seed", [(16, 0), (64, 1), (256, 2)])
def test_baseline_from_binned_matches_jax(max_bin, seed):
    X, y = _data(n=3000, d=5, seed=seed, missing=0.1)
    ours = bin_matrix(DataMatrix(X, y), max_bin, device="cpu")
    ref = jax_bin_matrix(JaxDataMatrix(X, y), max_bin)
    want = jax_model.baseline_from_binned(ref)
    assert model_telemetry.baseline_from_binned(ours) == want
    import torch

    from sagemaker_xgboost_container_tpu_torch.data.binning import BinnedMatrix

    as_tensor = BinnedMatrix(torch.as_tensor(np.asarray(ours.bins)), ours.cut_points,
                             ours.max_bin)
    assert model_telemetry.baseline_from_binned(as_tensor) == want
    rng = np.random.RandomState(seed + 10)
    raw = rng.randn(500, 5) * 1.5
    raw[rng.rand(500, 5) < 0.1] = np.nan
    cuts = [f["cuts"] for f in want["features"]]
    for a, b in zip(model_telemetry.bin_features(raw, cuts), jax_model.bin_features(raw, cuts)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(6))
def test_psi_and_groups_match_jax(seed):
    rng = np.random.RandomState(seed)
    k = rng.randint(3, 300)
    expected = rng.dirichlet(np.ones(k) * rng.choice([0.1, 1.0, 10.0]))
    counts = rng.multinomial(rng.randint(1, 5000), rng.dirichlet(np.ones(k)))
    assert abs(model_telemetry.psi(expected, counts) - jax_model.psi(expected, counts)) <= 1e-9
    for groups in (10, 3, 1):
        np.testing.assert_array_equal(model_telemetry.psi_groups(expected, groups),
                                      jax_model.psi_groups(expected, groups))
    assert model_telemetry.psi(expected, np.zeros(k)) == jax_model.psi(expected, np.zeros(k))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_drift_window_snapshot_matches_jax():
    X, y = _data(n=4000, d=4, seed=7)
    baseline = jax_model.baseline_from_binned(jax_bin_matrix(JaxDataMatrix(X, y), 32))
    clocks = (_Clock(), _Clock())
    ours = model_telemetry.DriftWindow(baseline, psi_max=0.2, window_s=10.0, min_rows=100,
                                       clock=clocks[0])
    ref = jax_model.DriftWindow(baseline, psi_max=0.2, window_s=10.0, min_rows=100,
                                clock=clocks[1])
    rng = np.random.RandomState(8)
    for step in range(8):
        for c in clocks:
            c.t = step * 3.0
        rows = rng.randn(60, 4) + (3.0 if step >= 4 else 0.0)
        preds = rng.rand(60)
        assert abs(ours.observe(rows, preds) - ref.observe(rows, preds)) <= 1e-9
        assert ours.snapshot() == ref.snapshot()
        assert ours.degraded == ref.degraded
    assert ours.degraded  # the shifted rows fill the window
    for c in clocks:
        c.t = 100.0  # every batch aged out: recovered
    assert ours.snapshot() == ref.snapshot() and not ours.degraded


def test_install_drift_is_gated_and_first_wins(model_env):
    baseline = {"version": 1, "rows": 2, "features": [{"cuts": [0.0], "fracs": [0.5, 0.5, 0.0]}]}
    assert model_telemetry.maybe_install_drift(baseline) is None
    model_env.setenv(model_telemetry.MODEL_TELEMETRY_ENV, "true")
    assert model_telemetry.maybe_install_drift(None) is None
    window = model_telemetry.maybe_install_drift(baseline)
    assert window is not None and model_telemetry.active_drift() is window
    assert model_telemetry.maybe_install_drift(dict(baseline, rows=3)) is window
    assert model_telemetry.drift_status()["rows"] == 0


# --------------------------------------------------------- serving drift
def _call(wsgi, body, path="/invocations", method="POST"):
    environ = {"PATH_INFO": path, "REQUEST_METHOD": method, "CONTENT_TYPE": "text/csv",
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    got = {}

    def start_response(status, headers, exc_info=None):
        got["status"] = int(status.split()[0])

    b"".join(wsgi(environ, start_response))
    return got["status"]


def _csv(X):
    return "\n".join(",".join(repr(float(v)) for v in row) for row in X).encode()


def test_served_drift_degrades_both_apps_alike(model_env, tmp_path):
    """A model whose manifest carries the training baseline, served by both
    apps with the plane on: in-distribution rows keep PSI under 0.2, rows
    shifted by 3 sigma drive it above and the lifecycle to DEGRADED; the
    PSI is the same in both."""
    model_env.setenv(model_telemetry.MODEL_TELEMETRY_ENV, "true")
    model_env.setenv("GRAFT_PREDICT_WARMUP", "0")
    X, y = _data(n=3000, d=6, seed=9, missing=0.0)
    forest = train(PARAMS, DataMatrix(X, y), 3, device="cpu", verbose_eval=False)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    path = str(model_dir / "xgboost-model")
    forest.save_model(path)
    integrity.write_manifest(path, drift_baseline=model_telemetry.drift_baseline())
    assert jax_integrity.check_model_file(path) == "verified"
    rng = np.random.RandomState(10)
    calm = rng.randn(400, 6).astype(np.float32)
    shifted = calm.copy()
    shifted[:, :3] += 3.0
    psi = {}
    for name, app_mod, lc, mt in (("port", app, lifecycle, model_telemetry),
                                  ("jax", jax_app, jax_lifecycle, jax_model)):
        mt._reset_for_tests()
        life = lc.install(lc.ServingLifecycle())
        service = (app_mod.ScoringService(str(model_dir), device="cpu") if name == "port"
                   else app_mod.ScoringService(str(model_dir)))
        wsgi = app_mod.make_app(service)
        for k in range(4):
            assert _call(wsgi, _csv(calm[k * 100:(k + 1) * 100])) == 200
        window = mt.active_drift()
        assert window is not None and window.snapshot()["psi"] < 0.2
        assert _call(wsgi, b"", path="/ping", method="GET") == 200
        assert life.state != lc.DEGRADED
        calm_psi = window.snapshot()["psi"]
        for k in range(4):
            assert _call(wsgi, _csv(shifted[k * 100:(k + 1) * 100])) == 200
        assert window.snapshot()["psi"] > 0.2
        _call(wsgi, b"", path="/ping", method="GET")
        assert life.state == lc.DEGRADED
        psi[name] = (calm_psi, window.snapshot()["psi"], window.snapshot()["per_feature_psi"])
        lc.uninstall()
    assert psi["port"] == psi["jax"]
    os.remove(path + ".manifest")


def test_fold_parallel_cv_emits_no_learning_records(model_env, tmp_path, capsys):
    """The fold-parallel CV path trains every fold on the class axis with
    no gbtree session: no learning record, as in the JAX package."""
    from sagemaker_xgboost_container_tpu_torch.models import cv_parallel
    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train

    model_env.setenv(model_telemetry.MODEL_TELEMETRY_ENV, "true")
    model_env.setenv("SM_OUTPUT_DATA_DIR", str(tmp_path / "output"))
    X, y = _data(n=600, missing=0.0)
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    np.savetxt(str(train_dir / "data.csv"), np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    ran = []
    real = cv_parallel.train_cv_parallel
    model_env.setattr(cv_parallel, "train_cv_parallel",
                      lambda *a, **k: ran.append(1) or real(*a, **k))
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    algorithm_train.sagemaker_train(
        {"num_round": "2", "max_depth": "3", "objective": "binary:logistic", "_kfold": "2"},
        {"train": channel}, str(train_dir), None, str(tmp_path / "model"), ["algo-1"],
        "algo-1", {}, device="cpu")
    assert ran == [1]
    assert not _records(capsys.readouterr().out, "training.learning")
