"""The port's cross-rank consensus guard (``training/consensus.py``)
against the JAX package's, on the CPU.

* parity: the same replies give both guards the same verdicts: agreement,
  a divergence (one ``training.divergence`` record with every digest, exit
  81), and the skips on world-size drift (a rank that missed a shrink) and
  round drift (a misaligned exchange);
* a port guard and a JAX guard exchange digests with each other over the
  cluster framing and agree on one forest;
* the guard sits before the checkpoint saver and the elastic drain point
  after the savers in ``get_callbacks``; nothing without the knobs;
* the drill: two hosts of the ``train`` entry point with the digest of rank
  1 perturbed (``consensus.check`` fault): both exit 81, each with one
  ``training.divergence`` record that carries both digests.
"""

import json
import threading
import time
import types

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.training import consensus as jax_consensus
from sagemaker_xgboost_container_tpu.training import watchdog as jax_watchdog
from sagemaker_xgboost_container_tpu.utils import faults as jax_faults
from sagemaker_xgboost_container_tpu.utils import integrity as jax_integrity
from sagemaker_xgboost_container_tpu_torch.constants import EXIT_CONSENSUS_DIVERGENCE
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models.booster import train
from sagemaker_xgboost_container_tpu_torch.training import (callbacks, consensus, elastic,
                                                            watchdog)
from sagemaker_xgboost_container_tpu_torch.utils import faults, integrity
from tests import util_torch_hosts as uh
from tests.util_ports import free_port

PACKAGES = {
    "port": types.SimpleNamespace(consensus=consensus, watchdog=watchdog, faults=faults,
                                  integrity=integrity),
    "jax": types.SimpleNamespace(consensus=jax_consensus, watchdog=jax_watchdog,
                                 faults=jax_faults, integrity=jax_integrity),
}
HOSTS = ["algo-1", "algo-2"]


@pytest.fixture(autouse=True)
def _clean_state():
    for m in PACKAGES.values():
        m.faults.reset()
        m.consensus._reset_for_tests()
    elastic._reset_for_tests()
    yield
    for m in PACKAGES.values():
        m.faults.reset()
        m.consensus._reset_for_tests()
    elastic._reset_for_tests()


@pytest.fixture(scope="module")
def forest():
    (X, y), _val = uh.host_rows(0)
    return train({"objective": "binary:logistic", "max_depth": 3, "max_bin": 16},
                 DataMatrix(X[:400], labels=y[:400]), 3, device="cpu", verbose_eval=False)


@pytest.fixture(scope="module")
def jax_forest(forest, tmp_path_factory):
    """The same model file, loaded by the JAX package."""
    from sagemaker_xgboost_container_tpu.models import compat as jax_compat

    path = str(tmp_path_factory.mktemp("consensus") / "xgboost-model")
    forest.save_model(path)
    return jax_compat.load_model_any_format(path)[0]


def _guard(pkg, replies, aborts, rank=0):
    m = PACKAGES[pkg]
    return m.consensus.ConsensusGuard(
        every=1, hosts=HOSTS, current_host=HOSTS[rank],
        exchange=lambda digest, rnd: replies(digest, rnd),
        abort_fn=lambda reason, code, **fields: aborts.append((reason, code, fields)))


@pytest.mark.parametrize("case", ["agree", "diverge", "world_drift", "round_drift",
                                  "bare_digests", "exchange_fails"])
def test_guard_verdicts_like_jax(forest, jax_forest, capfd, monkeypatch, case):
    """The same replies to a port guard and a JAX guard over the same trees
    (their digests are equal): the same verdict, abort and record."""
    monkeypatch.setenv("SM_STRUCTURED_METRICS", "true")
    other = "0" * 64

    def replies(digest, rnd):
        if case == "exchange_fails":
            raise OSError("peer unreachable")
        if case == "bare_digests":
            return [digest, other]
        mine = {"digest": digest, "round": rnd, "world": 2}
        theirs = {"agree": dict(mine), "diverge": dict(mine, digest=other),
                  "world_drift": dict(mine, digest=other, world=3),
                  "round_drift": dict(mine, digest=other, round=rnd + 1)}[case]
        return [mine, theirs]

    out = {}
    capfd.readouterr()
    for pkg, model in (("port", forest), ("jax", jax_forest)):
        aborts = []
        guard = _guard(pkg, replies, aborts)
        stop = guard.after_iteration(model, 4, {})
        records = [json.loads(line) for line in capfd.readouterr().out.splitlines()
                   if line.startswith('{"metric": "training.divergence"')]
        out[pkg] = (stop, guard.checks, guard.divergences, aborts, records)
    assert out["port"] == out["jax"]
    stop, checks, divergences, aborts, records = out["port"]
    assert stop is False and checks == 1
    if case in ("diverge", "bare_digests"):
        digest = integrity.forest_digest(forest)
        assert divergences == 1 and records == [{
            "metric": "training.divergence", "round": 4, "rank": 0, "world_size": 2,
            "digests": {"0": digest, "1": other}}]
        assert aborts == [("consensus_divergence", EXIT_CONSENSUS_DIVERGENCE,
                           {"round": 4, "digests": {"0": digest, "1": other}})]
    else:
        assert divergences == 0 and aborts == [] and records == []


@pytest.mark.parametrize("every, want", [(1, [0, 1, 2, 3, 4, 5]), (3, [2, 5])])
def test_guard_checks_every_n_rounds(forest, every, want):
    seen = []
    guard = consensus.ConsensusGuard(every, exchange=lambda d, rnd: seen.append(rnd) or [d])
    for epoch in range(6):
        guard.after_iteration(forest, epoch, {})
    assert seen == want and guard.checks == len(want)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_fault_point_perturbs_the_digest(forest, jax_forest, pkg):
    """``consensus.check:error`` makes this rank claim a digest whose first
    eight hex digits are f's, in both packages."""
    m = PACKAGES[pkg]
    m.faults.configure("consensus.check:error@2")
    claimed = []
    model = forest if pkg == "port" else jax_forest
    guard = m.consensus.ConsensusGuard(1, exchange=lambda d, rnd: claimed.append(d) or [d])
    for epoch in range(3):
        guard.after_iteration(model, epoch, {})
    digest = m.integrity.forest_digest(model)
    assert claimed == [digest, "f" * 8 + digest[8:], digest]


@pytest.mark.parametrize("master", ["port", "jax"])
def test_port_and_jax_guards_exchange_digests(forest, jax_forest, master):
    """Two ranks, one a port guard and one a JAX guard, allgather over the
    consensus port (the cluster framing): same forest, same digest, no
    abort."""
    port = free_port()
    models = {"port": forest, "jax": jax_forest}
    order = [master, "jax" if master == "port" else "port"]
    aborts, errors = [], []

    def run(rank):
        try:
            pkg = order[rank]
            guard = PACKAGES[pkg].consensus.ConsensusGuard(
                1, hosts=HOSTS, current_host=HOSTS[rank], port=port, timeout=20,
                master_addr="127.0.0.1", abort_fn=lambda *a, **k: aborts.append(a))
            guard.after_iteration(models[pkg], 0, {})
            assert guard.checks == 1 and guard.divergences == 0
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    threads[0].start()
    time.sleep(0.2)
    threads[1].start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not aborts


def test_default_abort_rank_0_coordinates_the_peers(monkeypatch):
    calls = []
    monkeypatch.setattr(watchdog, "coordinate_abort", lambda *a, **k: calls.append(("co", a)))
    monkeypatch.setattr(watchdog, "request_abort", lambda *a, **k: calls.append(("local", a)))
    for rank in (0, 1):
        consensus.ConsensusGuard(1, hosts=HOSTS, current_host=HOSTS[rank])._default_abort(
            "consensus_divergence", EXIT_CONSENSUS_DIVERGENCE, round=2)
    assert calls == [("co", (HOSTS, "algo-1", "consensus_divergence")),
                     ("local", ("consensus_divergence", EXIT_CONSENSUS_DIVERGENCE))]


def test_maybe_guard_follows_the_knob_and_membership(monkeypatch):
    monkeypatch.delenv(consensus.CONSENSUS_EVERY_ENV, raising=False)
    assert consensus.maybe_consensus_guard() is None
    monkeypatch.setenv(consensus.CONSENSUS_EVERY_ENV, "4")
    guard = consensus.maybe_consensus_guard()
    assert (guard.every, guard.world_size, guard.rank) == (4, 1, 0)
    consensus.register_cluster(["c", "a", "b"], "b")
    guard = consensus.maybe_consensus_guard()
    assert (guard.hosts, guard.rank, guard.world_size) == (["a", "b", "c"], 1, 3)


def _phases(cbs):
    return [getattr(cb, "phase", type(cb).__name__) for cb in cbs]


def test_get_callbacks_places_the_guard_and_the_drain_point(tmp_path, monkeypatch):
    """The JAX package's order: monitor, consensus, checkpoint, the elastic
    drain point, then early stopping and RoundTimer; neither without the
    knobs."""
    kwargs = dict(model_dir=str(tmp_path / "model"), checkpoint_dir=str(tmp_path / "ckpt"),
                  early_stopping_data_name="validation", early_stopping_metric="logloss",
                  early_stopping_rounds=3, save_model_on_termination="false",
                  is_master=True, num_round=10, train_cfg={"objective": "binary:logistic"})
    monkeypatch.delenv(consensus.CONSENSUS_EVERY_ENV, raising=False)
    _model, _it, cbs = callbacks.get_callbacks(**kwargs)
    assert _phases(cbs) == ["eval_monitor", "checkpoint", "early_stopping", "RoundTimer"]
    monkeypatch.setenv(consensus.CONSENSUS_EVERY_ENV, "2")
    monkeypatch.setenv(elastic.ELASTIC_ENV, "1")
    elastic.register_cluster(HOSTS, "algo-1")
    _model, _it, cbs = callbacks.get_callbacks(**kwargs)
    assert _phases(cbs) == ["eval_monitor", "consensus", "checkpoint", "elastic",
                            "early_stopping", "RoundTimer"]
    for cb in cbs:
        stop = getattr(getattr(cb, "inner", cb), "stop", None)
        if stop:
            stop()


def test_divergence_drill_exits_81_on_both_hosts(tmp_path):
    """Two hosts, the digest of rank 1 perturbed at its 3rd check: both
    exit 81 at that round, each with one training.divergence record that
    carries both digests, and no model."""
    outs = uh.finish(uh.start_hosts(tmp_path, 2, [
        {"SM_CONSENSUS_EVERY": "1"},
        {"SM_CONSENSUS_EVERY": "1", "SM_FAULT_SPEC": "consensus.check:error@3"}]), timeout=120)
    seen = []
    for rank, (code, out, err, root) in enumerate(outs):
        assert code == EXIT_CONSENSUS_DIVERGENCE, err[-3000:]
        records = uh.records(out, "training.divergence")
        assert len(records) == 1, out[-2000:]
        r = records[0]
        assert (r["round"], r["rank"], r["world_size"]) == (2, rank, 2)
        assert set(r["digests"]) == {"0", "1"}
        assert r["digests"]["1"] == "f" * 8 + r["digests"]["0"][8:]
        seen.append(r["digests"])
        aborts = uh.records(out, "training.abort")
        assert len(aborts) == 1 and aborts[0]["exit_code"] == EXIT_CONSENSUS_DIVERGENCE
        assert uh.drill_report(out)["checks"] == 3
        assert not np.any([line.startswith("[3]") for line in out.splitlines()])
    assert seen[0] == seen[1]
