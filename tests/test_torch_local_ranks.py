"""One training process per local GPU (``parallel/local.py``), the port's
counterpart of the JAX package's data mesh over a host's devices, on the
CPU: two gloo ranks, each a local rank of one host dealing itself its shard
as the entry point deals it.

* the session's cuts are the host's: equal to JAX ``bin_matrix`` over all
  rows, where each rank's own merged sketch differs;
* the trees equal the JAX 2-device mesh's for binary, softprob, lossguide,
  exact, rank:ndcg and survival:cox;
* the group layout deals whole query groups as the JAX one does;
* ``_num_devices`` and ``SM_LOCAL_RANKS`` resolve L as specified;
* with L == 1 nothing is spawned and no process group forms.
(The entry point with local ranks: ``tests/test_torch_local_entry.py``.)
"""

import json

import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jax
from sagemaker_xgboost_container_tpu.data.binning import bin_matrix as jax_bin_matrix
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.ops.ranking import (
    build_sharded_group_layout as jax_sharded_layout,
)
from sagemaker_xgboost_container_tpu_torch.ops.ranking import assign_groups
from sagemaker_xgboost_container_tpu_torch.parallel import local
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from tests import util_torch_local as ul
from tests import util_torch_ranks as ur

# leaf values and predictions: the ranks sum their histograms in another
# order than the JAX mesh's psum, an f32 rounding difference
VALUE_TOL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    return ur.run_ranks(ul.local_suite, timeout=240)


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.array(jax.devices()[:2]), axis_names=("data",))


def test_host_cuts_equal_jax_bin_matrix_over_all_rows(ranks):
    want = jax_bin_matrix(JaxDataMatrix(ul.cut_data()), ul.CUT_MAX_BIN).cut_points
    assert [r["rows"] for r in ranks] == [ul.CUT_ROWS // 2] * 2
    for r in ranks:
        assert len(r["host cuts"]) == len(want)
        for a, b in zip(r["host cuts"], want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(b))
    # each rank's own sketch, merged as across hosts, is other cuts on this
    # fixture: the host's cuts are not what a per-rank merge would give
    assert any(not np.array_equal(a, np.asarray(b))
               for a, b in zip(ranks[0]["merged cuts"], want))


@pytest.mark.parametrize("name", list(ul.LOCAL_CASES))
def test_local_rank_trees_match_jax_mesh(ranks, mesh2, name):
    arrays, preds, raw = ranks[0][name]
    assert raw == ranks[1][name][2]          # every rank commits the same model
    params, rounds = ul.LOCAL_CASES[name]
    X, y, groups = ul.local_case_data(name)
    ref = jax_booster.train(dict(params), JaxDataMatrix(X, labels=y, groups=groups),
                            num_boost_round=rounds, mesh=mesh2)
    assert len(arrays) == len(ref.trees)
    for t, (a, b) in enumerate(zip(arrays, ref.trees)):
        for key in ("feature", "threshold", "default_left", "left", "right"):
            assert np.array_equal(a[key], np.asarray(getattr(b, key))), (name, t, key)
        np.testing.assert_allclose(a["value"], b.value, atol=VALUE_TOL, err_msg=name)
    np.testing.assert_allclose(preds, ref.predict(X), atol=VALUE_TOL, err_msg=name)


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_group_layout_matches_jax(shards):
    sizes = np.maximum(1, np.random.RandomState(shards).lognormal(3, 1, 200)).astype(np.int64)
    jperm, _ri, jrps = jax_sharded_layout(sizes, shards)
    assign = assign_groups(sizes, shards)
    assert sorted(g for a in assign for g in a) == list(range(len(sizes)))
    assert max(int(sizes[a].sum()) for a in assign) == jrps
    # each shard's rows are its groups' rows in channel order, as the JAX
    # layout's permutation lists them
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix

    n = int(sizes.sum())
    dm = DataMatrix(np.arange(n, dtype=np.float32)[:, None], groups=sizes)
    for r in range(shards):
        rows, groups = local.shard_rows(dm, r, shards)
        block = jperm[r * jrps:(r + 1) * jrps]
        np.testing.assert_array_equal(rows, block[block >= 0])
        assert int(groups.sum()) == len(rows)


def test_contiguous_shards_at_the_jax_boundaries():
    assert local.shard_bounds(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert local.shard_bounds(1_100_000, 2) == [(0, 550_000), (550_000, 1_100_000)]
    np.testing.assert_array_equal(
        local.shard_indices(np.arange(7) * 2, local.Topology(1, 0, 2, 1)), [8, 10, 12])


@pytest.mark.parametrize("env, hosts, cap, cards, device, want", [
    ({}, 1, None, 8, "cuda", 8),
    ({}, 1, 4, 8, "cuda", 4),
    ({}, 2, 4, 8, "cuda", 2),
    ({}, 4, 2, 8, "cuda", 1),          # the share is at least 1
    ({}, 1, None, 0, "cpu", 1),
    ({}, 1, 16, 2, "cuda", 2),
    ({"SM_LOCAL_RANKS": "3"}, 1, None, 0, "cpu", 3),
    ({"SM_LOCAL_RANKS": "2"}, 1, 1, 8, "cuda", 2),   # the knob wins over the cap
    ({"SM_LOCAL_RANKS": "2", "SM_PROCESS_GROUP_BACKEND": "gloo"}, 1, None, 1, "cuda", 2),
])
def test_local_world_size_resolution(monkeypatch, env, hosts, cap, cards, device, want):
    for key in ("SM_LOCAL_RANKS", "SM_PROCESS_GROUP_BACKEND"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = local.local_world_size(hosts, cap, torch.device(device), device_count=cards)
    assert got == want


@pytest.mark.parametrize("value", ["2", "0", "x"])
def test_local_ranks_refused(monkeypatch, value):
    monkeypatch.delenv("SM_PROCESS_GROUP_BACKEND", raising=False)
    monkeypatch.setenv("SM_LOCAL_RANKS", value)
    with pytest.raises(exc.UserError):
        # "2": two ranks on one card over NCCL
        local.local_world_size(1, None, torch.device("cuda"), device_count=1)


def _channels(tmp_path):
    (X, y), (Xv, yv) = ur.entry_data()
    paths = {}
    for name, (A, b) in (("train", (X, y)), ("validation", (Xv, yv))):
        d = tmp_path / name
        d.mkdir()
        np.savetxt(d / "data.csv", np.column_stack([b, A]), delimiter=",", fmt="%.9g")
        paths[name] = str(d)
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    return paths, {"train": channel, "validation": dict(channel)}


def _sagemaker_train(tmp_path, hp, model="model"):
    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train

    (tmp_path / model).mkdir()
    paths, data_cfg = _channels(tmp_path / model)
    algorithm_train.sagemaker_train(dict(hp), data_cfg, paths["train"], paths["validation"],
                                    str(tmp_path / model / "out"), ["algo-1"], "algo-1", {},
                                    device="cpu")
    with open(tmp_path / model / "out" / "xgboost-model", "rb") as f:
        return f.read()


def test_one_rank_a_host_spawns_nothing(tmp_path, monkeypatch):
    """L == 1: no process, no shared memory, no process group; the model is
    the same bytes with the knob unset and at 1."""
    import torch.distributed as dist

    from sagemaker_xgboost_container_tpu_torch.parallel import distributed

    monkeypatch.setenv("SM_OUTPUT_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.delenv("SM_LOCAL_RANKS", raising=False)

    def refuse(*_a, **_k):
        raise AssertionError("L == 1 must not reach the local-rank path")

    monkeypatch.setattr(local, "spawn_local_ranks", refuse)
    monkeypatch.setattr(local.HostMatrix, "publish", refuse)
    monkeypatch.setattr(distributed, "init_process_group", refuse)
    unset = _sagemaker_train(tmp_path, ur.ENTRY_HP, "unset")
    assert local.active_local_ranks() is None and not dist.is_initialized()
    monkeypatch.setenv("SM_LOCAL_RANKS", "1")
    assert _sagemaker_train(tmp_path, ur.ENTRY_HP, "one") == unset
    doc = json.loads(unset)
    assert len(doc["learner"]["gradient_booster"]["model"]["trees"]) == 4


def test_num_devices_is_honoured(tmp_path, monkeypatch):
    """``_num_devices`` reaches the rank count and no longer reaches the
    booster's config."""
    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train

    monkeypatch.setenv("SM_OUTPUT_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.delenv("SM_LOCAL_RANKS", raising=False)
    seen = {}
    resolve = local.local_world_size

    def spy(num_hosts, cap=None, device=None, device_count=None):
        seen["args"] = (num_hosts, cap)
        return resolve(num_hosts, cap, device, device_count)

    job = algorithm_train.train_job

    def spy_job(train_cfg, *args, **kwargs):
        seen["cfg"] = dict(train_cfg)
        return job(train_cfg, *args, **kwargs)

    monkeypatch.setattr(local, "local_world_size", spy)
    monkeypatch.setattr(algorithm_train, "train_job", spy_job)
    _sagemaker_train(tmp_path, dict(ur.ENTRY_HP, _num_devices="2"))
    assert seen["args"] == (1, 2)
    assert "_num_devices" not in seen["cfg"]


def test_status_reports_the_hosts_local_ranks(tmp_path, monkeypatch):
    """``sagemaker_train`` in this process as the leader of two local ranks:
    ``/status`` carries L and each local rank's device, no worker outlives
    the job, and the model is the one rank's trees."""
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
    from sagemaker_xgboost_container_tpu_torch.telemetry import fleet
    from tests.util_ports import free_port

    monkeypatch.setenv("SM_OUTPUT_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("SM_LOCAL_RANKS", "2")
    monkeypatch.setenv("SM_PROCESS_GROUP_PORT", str(free_port()))
    threads = torch.get_num_threads()
    seen = {}
    note = fleet.note_status

    def spy(**fields):
        seen.update(fields)
        return note(**fields)

    monkeypatch.setattr(fleet, "note_status", spy)
    try:
        _sagemaker_train(tmp_path, ur.ENTRY_HP)
    finally:
        torch.set_num_threads(threads)
    assert seen["local_ranks"] == 2 and seen["local_devices"] == ["cpu", "cpu"]
    assert local.active_local_ranks() is None and local.topology() is None
    import multiprocessing

    assert not multiprocessing.active_children()
    forest = Forest.load_model(str(tmp_path / "model" / "out" / "xgboost-model"), device="cpu")
    assert len(forest.trees) == 4


def test_across_hosts_one_sketch_a_host_is_merged():
    """Two hosts x two local ranks: every rank bins with the merge of the
    two hosts' sketches (each of all its host's rows), not of four ranks'."""
    from sagemaker_xgboost_container_tpu_torch.data.binning import compute_cut_points
    from sagemaker_xgboost_container_tpu_torch.models.booster import (
        candidate_matrix,
        merge_cut_candidates,
    )

    got = ur.run_ranks(ul.two_host_cuts, world=4, timeout=180)
    X, half, width = ul.cut_data(), ul.CUT_ROWS // 2, ul.CUT_MAX_BIN - 1
    mats, counts = zip(*(candidate_matrix(compute_cut_points(part, None, ul.CUT_MAX_BIN), width)
                         for part in (X[:half], X[half:])))
    want = merge_cut_candidates(np.stack(mats), np.stack(counts), width)
    for cuts in got:
        assert len(cuts) == len(want)
        for a, b in zip(cuts, want):
            np.testing.assert_array_equal(a, b)
