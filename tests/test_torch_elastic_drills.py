"""The elastic shrink-to-continue drills of the port's multi-host ``train``
entry point on the CPU: three hosts on loopback (``tests/util_torch_hosts``),
one gloo process group, each host its own rows, 10 rounds of depth 4.

* rank 2 SIGKILLed at its 5th round end with ``SM_ELASTIC=1``: the
  survivors' next collective fails, rank 0 calls rank 2 stale and shrinks,
  both re-form at world size 2, resume from rank 0's checkpoint at round 5
  and exit 0 with byte-equal models; the manifests record one transition;
* the same kill with ``rendezvous.reform`` faulted: both survivors exit 82
  and leave a flight-recorder dump;
* rank 0 killed with ``SM_ELASTIC=1``: not survivable, the survivors exit
  80 once the drain deadline passes without a verdict.

(The same kill without ``SM_ELASTIC``: ``test_torch_parallel.py``'s
``test_host_loss_survivor_exits_80``.)
"""

import json
import os
import signal

import numpy as np

from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.utils import integrity
from tests import util_torch_hosts as uh

ELASTIC = {"SM_ELASTIC": "1", "SM_TRACE": "true"}
KILL_AT = 5   # rank 2 dies at its 5th round end: rounds 0-4 are committed
TREE_KEYS = ("feature", "threshold", "default_left", "left", "right", "value")


def _trees(forest):
    return [{k: np.asarray(getattr(t, k)) for k in TREE_KEYS} for t in forest.trees]


def test_shrink_to_continue_three_to_two(tmp_path):
    outs = uh.finish(uh.start_hosts(tmp_path, 3, [
        dict(ELASTIC), dict(ELASTIC),
        dict(ELASTIC, SM_FAULT_SPEC="training.round_end:kill@{}".format(KILL_AT))]),
        timeout=150)
    codes = [o[0] for o in outs]
    assert codes[2] == -signal.SIGKILL
    for code, out, err, _root in outs[:2]:
        assert code == 0, err[-3000:]
    reports = [uh.drill_report(o[1]) for o in outs[:2]]
    with open(reports[0]["model"], "rb") as f0, open(reports[1]["model"], "rb") as f1:
        assert f0.read() == f1.read()     # byte-equal survivor models
    transitions = [uh.records(o[1], "training.membership") for o in outs[:2]]
    assert transitions[0] == transitions[1]
    assert len(transitions[0]) == 1
    t = transitions[0][0]
    assert (t["old_world_size"], t["new_world_size"], t["surviving_ranks"], t["generation"],
            t["reason"], t["epoch"]) == (3, 2, [0, 1], 1, "stale_host", KILL_AT - 1)
    root0 = outs[0][3]
    model = os.path.join(root0, "model", "xgboost-model")
    manifest = integrity.read_manifest(model)
    assert [{k: v for k, v in e.items()} for e in manifest["membership_log"]] == [
        {k: v for k, v in t.items() if k != "metric"}]
    assert manifest["fingerprint"]["world_size"] == 2
    final = Forest.load_model(model, device="cpu")
    assert final.num_boosted_rounds == uh.ROUNDS
    # rounds 1-5 are the checkpoint's, byte for byte
    ckpt = Forest.load_model(os.path.join(root0, "checkpoints", "xgboost-checkpoint.{}".format(
        KILL_AT - 1)), device="cpu")
    for a, b in zip(_trees(final)[:KILL_AT], _trees(ckpt)):
        for k in TREE_KEYS:
            assert np.array_equal(a[k], b[k]), k
    assert len(ckpt.trees) == KILL_AT
    # every survivor printed every round's metric line once: 0-4 before the
    # shrink, 5-9 after
    for _code, out, _err, _root in outs[:2]:
        rounds = [int(line[1:line.index("]")]) for line in out.splitlines()
                  if line.startswith("[") and "\t" in line]
        assert rounds == list(range(uh.ROUNDS))
    with open(os.path.join(root0, "checkpoints", "xgboost-checkpoint.{}.manifest".format(
            uh.ROUNDS - 1))) as f:
        assert json.load(f)["membership_log"][0]["new_world_size"] == 2


def test_reform_failure_exits_82_with_flight_recorder(tmp_path):
    faulted = dict(ELASTIC, SM_FAULT_SPEC="rendezvous.reform:error:injected reform outage",
                   SM_IO_RETRY_ATTEMPTS="2")
    outs = uh.finish(uh.start_hosts(tmp_path, 3, [
        dict(faulted), dict(faulted),
        dict(ELASTIC, SM_FAULT_SPEC="training.round_end:kill@{}".format(KILL_AT))]),
        timeout=150)
    assert outs[2][0] == -signal.SIGKILL
    for rank, (code, out, err, root) in enumerate(outs[:2]):
        assert code == 82, err[-3000:]
        aborts = uh.records(out, "training.abort")
        assert len(aborts) == 1 and aborts[0]["reason"] == "reform_failed"
        assert aborts[0]["exit_code"] == 82 and aborts[0]["generation"] == 1
        dump = aborts[0]["flight_recorder"]
        assert os.path.basename(dump) == "flight-recorder-rank{}.json".format(rank)
        assert os.path.exists(dump) and dump.startswith(root)
        assert not uh.records(out, "training.membership")
        assert not os.path.exists(os.path.join(root, "model", "xgboost-model"))


def test_dead_master_is_not_survivable(tmp_path):
    """Only rank 0 proposes a shrink: with rank 0 dead no verdict comes, and
    the survivors take the coordinated abort at the drain deadline (the
    first to reach it tells the other)."""
    survivor = dict(ELASTIC, SM_REFORM_DRAIN_TIMEOUT_S="3")
    outs = uh.finish(uh.start_hosts(tmp_path, 3, [
        dict(ELASTIC, SM_FAULT_SPEC="training.round_end:kill@{}".format(KILL_AT)),
        dict(survivor), dict(survivor)]), timeout=150)
    assert outs[0][0] == -signal.SIGKILL
    for code, out, err, _root in outs[1:]:
        assert code == 80, err[-3000:]
        aborts = uh.records(out, "training.abort")
        assert len(aborts) == 1 and aborts[0]["reason"] == "collective_failed"
        assert "waiting up to 3s for the shrink verdict" in out
        assert not uh.records(out, "training.membership")
    assert any("no shrink verdict" in out for _code, out, _err, _root in outs[1:])
