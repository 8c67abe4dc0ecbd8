"""Data-parallel training of the port across ranks, against the JAX
package's data mesh.

One pair of CPU gloo ranks (spawned processes) computes everything the
module needs (``tests/util_torch_ranks.distributed_suite``): the histogram
collectives, the split merge, four training cases under the ``psum``
lowering (and a sampled one) and three under ``reduce_scatter``, and the
fingerprint's world size. The tests hold those results to the JAX
package's functions on two of conftest's eight virtual devices
(``shard_map``, ``train(mesh=)``) over the same inputs.
"""

import os

import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import jax
import jax.numpy as jnp
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.ops import histogram as jax_hist
from sagemaker_xgboost_container_tpu.ops import split as jax_split
from sagemaker_xgboost_container_tpu_torch.data.binning import compute_cut_points
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import booster
from sagemaker_xgboost_container_tpu_torch.ops import histogram
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.utils import integrity
from tests import util_torch_ranks as ur

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map


@pytest.fixture(scope="module")
def ranks():
    return ur.run_ranks(ur.distributed_suite, timeout=240)


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.array(jax.devices()[:2]), axis_names=("data",))


def _shard_map(fn, mesh, n_in, n_out):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("data"),) * n_in,
                             out_specs=(P("data"),) * n_out))


# ------------------------------------------------------------- collectives
@pytest.mark.parametrize("comm", ["psum", "reduce_scatter"])
@pytest.mark.parametrize("key", ["hist", "hist async"])
def test_apply_hist_collective_bitwise_equals_jax(ranks, mesh2, comm, key):
    G = np.concatenate([ur.hist_inputs(r)[0] for r in range(2)])
    H = np.concatenate([ur.hist_inputs(r)[1] for r in range(2)])
    f = _shard_map(lambda g, h: jax_hist.apply_hist_collective(g, h, "data", comm, 2),
                   mesh2, 2, 2)
    jg, jh = (np.asarray(a) for a in f(jnp.asarray(G), jnp.asarray(H)))
    W = ur.HIST_SHAPE[0]
    for r in range(2):
        g, h = ranks[r][key, comm]
        assert np.array_equal(g, jg[r * W:(r + 1) * W]), (comm, r)
        assert np.array_equal(h, jh[r * W:(r + 1) * W]), (comm, r)
    if comm == "reduce_scatter":
        # each rank holds its feature slice of the padded width
        assert g.shape == (W, histogram.padded_feature_width(5, 2) // 2, ur.HIST_SHAPE[2])


def test_combine_splits_across_shards_equals_jax_with_ties(ranks, mesh2):
    parts = [ur.split_inputs(r) for r in range(2)]
    keys = ("gain", "feature", "bin", "default_left", "g_total", "h_total")
    cat = [jnp.asarray(np.concatenate([p[k] for p in parts])) for k in keys]

    def fn(*arrays):
        shard = jax.lax.axis_index("data")
        out = jax_split.combine_splits_across_shards(
            dict(zip(keys, arrays)), shard, ur.SPLIT_D_LOCAL, "data")
        return tuple(out[k] for k in keys)

    ref = [np.asarray(a) for a in _shard_map(fn, mesh2, 6, 6)(*cat)]
    W = len(parts[0]["gain"])
    for r in range(2):
        got = ranks[r]["combine"]
        for k, want in zip(keys, ref):
            assert np.array_equal(got[k], want[r * W:(r + 1) * W]), (k, r)
    # the ties went to the lowest global feature: rank 0's
    assert list(ranks[0]["combine"]["feature"][[0, 2, 4]]) == [3, 1, 2]
    assert list(ranks[0]["combine"]["feature"][[1, 5]]) == [4, 2]


def test_broadcast_node_totals_equals_jax(ranks, mesh2):
    G = np.concatenate([ur.totals_inputs(r)[0] for r in range(2)])
    H = np.concatenate([ur.totals_inputs(r)[1] for r in range(2)])

    def fn(g, h):
        return jax_split.broadcast_node_totals(g, h, jax.lax.axis_index("data"), "data")

    jg, jh = (np.asarray(a) for a in _shard_map(fn, mesh2, 2, 2)(jnp.asarray(G),
                                                                   jnp.asarray(H)))
    W = ur.HIST_SHAPE[0]
    for r in range(2):
        assert np.array_equal(ranks[r]["totals"][0], jg[r * W:(r + 1) * W])
        assert np.array_equal(ranks[r]["totals"][1], jh[r * W:(r + 1) * W])
    # rank 0's feature-0 totals, on both ranks
    want = ur.totals_inputs(0)[0][:, 0, :].sum(-1)
    assert np.array_equal(ranks[1]["totals"][0], want)


def test_round_comm_plan_equals_jax():
    for args in (("depthwise", 8, 0, 28, 257, 2, "psum", True),
                 ("depthwise", 6, 0, 5, 33, 4, "reduce_scatter", False),
                 ("lossguide", 0, 15, 7, 65, 2, "reduce_scatter", True)):
        assert histogram.round_comm_plan(*args) == jax_hist.round_comm_plan(*args)
    # the main path's round on two ranks: 128 node histograms and the totals
    assert histogram.round_comm_plan("depthwise", 8, 0, 28, 257, 2, "psum", True)[1] == (
        128 * 28 * 257 * 2 * 4 + 2 * 256 * 4)


# ---------------------------------------------------------------- training
def _jax_train(name, mesh):
    params, _n, _split, rounds, _kw = ur.TRAIN_CASES[name]
    X, y = ur.case_data(name)
    return jax_booster.train(dict(params), JaxDataMatrix(X, labels=y), num_boost_round=rounds,
                             mesh=mesh), X


@pytest.mark.parametrize("name", sorted(ur.TRAIN_CASES))
def test_two_ranks_match_jax_data_mesh(ranks, mesh2, name):
    ref, X = _jax_train(name, mesh2)
    trees, preds, raw, _log = ranks[0]["train", name, "psum"]
    # every rank commits the same model, byte for byte
    assert raw == ranks[1]["train", name, "psum"][2]
    assert len(trees) == len(ref.trees)
    for t, (a, b) in enumerate(zip(trees, ref.trees)):
        for key in ("feature", "threshold", "default_left", "left", "right"):
            assert np.array_equal(a[key], np.asarray(getattr(b, key))), (name, t, key)
        np.testing.assert_allclose(a["value"], b.value, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(preds, ref.predict(X), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", ["binary", "softprob", "lossguide"])
def test_psum_and_reduce_scatter_trees_bitwise(ranks, name):
    for r in range(2):
        a = ranks[r]["train", name, "psum"]
        b = ranks[r]["train", name, "reduce_scatter"]
        assert a[2] == b[2], (name, r)     # the saved models, byte for byte
        assert np.array_equal(a[1], b[1])


def test_sampled_ranks_commit_one_model(ranks):
    """Row and column sampling across ranks: the column draws are the same
    on every rank and each keeps its own rows, so both save one model."""
    a, b = (ranks[r]["train", "sampled", "psum"] for r in range(2))
    assert a[2] == b[2]
    assert len(a[0]) == 3 and np.all(np.isfinite(a[1]))


def test_sampler_column_draws_do_not_depend_on_rows():
    """Across ranks the keep masks come from a generator of their own: two
    ranks of different row counts draw the same column masks, and their
    own rows' masks."""
    from sagemaker_xgboost_container_tpu_torch.models.sampling import Sampler

    config = booster.TrainConfig(ur.OWN_CASES["sampled"][0])
    d0, d1 = (Sampler(config, n, 5, "cpu", rank=r).draw(2)[0] for r, n in ((0, 600), (1, 403)))
    assert torch.equal(d0.masks.tree, d1.masks.tree)
    assert torch.equal(d0.masks.node, d1.masks.node)
    assert d0.keep.shape == (600,) and d1.keep.shape == (403,)
    assert not torch.equal(d0.keep[:403], d1.keep)
    # one rank draws as it always did
    one = Sampler(config, 600, 5, "cpu").draw(2)[0]
    again = Sampler(config, 600, 5, "cpu").draw(2)[0]
    assert torch.equal(one.keep, again.keep) and torch.equal(one.masks.node, again.masks.node)


def test_metric_lines_identical_on_every_rank(ranks):
    logs = [ranks[r]["train", "binary", "psum"][3] for r in range(2)]
    assert logs[0] == logs[1]
    ll = logs[0]["train"]["logloss"]
    assert len(ll) == 4 and all(a > b for a, b in zip(ll, ll[1:]))
    # logloss combines exactly from the ranks' partial sums: it equals the
    # metric over all rows
    from sagemaker_xgboost_container_tpu.models import eval_metrics

    X, y = ur.case_data("binary")
    want = eval_metrics.logloss(ranks[0]["train", "binary", "psum"][1], y)
    assert abs(ll[-1] - want) < 1e-5


def test_merged_cuts_equal_jax_merge(monkeypatch):
    """The port's merge of two shards' candidates against the JAX package's
    ``_merged_distributed_cuts`` with its gather replaced by the same two
    shards' candidates (real-valued data, so the merge thins)."""
    from jax.experimental import multihost_utils

    rng = np.random.RandomState(7)
    X = rng.randn(1500, 4).astype(np.float32)
    X[rng.rand(1500, 4) < 0.05] = np.nan
    shards = [X[:900], X[900:]]
    max_bin = 32
    width = max_bin - 1
    mats, counts = [], []
    for part in shards:
        cuts = compute_cut_points(part, None, max_bin)
        mat = np.full((4, width), np.nan, np.float32)
        cnt = np.zeros(4, np.int32)
        for f, c in enumerate(cuts):
            mat[f, :len(c)] = c
            cnt[f] = len(c)
        mats.append(mat)
        counts.append(cnt)
    ours = booster.merge_cut_candidates(np.stack(mats), np.stack(counts), width)
    gathered = iter([np.stack(mats), np.stack(counts)])
    monkeypatch.setattr(multihost_utils, "process_allgather", lambda x: next(gathered))
    ref = jax_booster._merged_distributed_cuts(JaxDataMatrix(shards[0]), max_bin)
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert np.array_equal(a, b)
    assert max(len(c) for c in ours) == width   # the union was thinned


# ----------------------------------------------------------- fingerprint
def test_fingerprint_carries_the_groups_world_size(ranks, tmp_path, monkeypatch, caplog):
    assert ranks[0]["world_size"] == ranks[1]["world_size"] == 2
    assert integrity.config_fingerprint({})["world_size"] == 1   # no group here
    # a checkpoint written by two ranks, resumed by one: reported as the JAX
    # package reports it (a warning naming world_size; refused when strict)
    from sagemaker_xgboost_container_tpu.utils import integrity as jax_integrity

    path = tmp_path / "xgboost-checkpoint.3"
    path.write_bytes(b"{}")
    fp = integrity.config_fingerprint({"objective": "binary:logistic"}, world_size=2)
    integrity.write_manifest(str(path), fingerprint=fp)
    live = integrity.config_fingerprint({"objective": "binary:logistic"})
    assert integrity.fingerprint_mismatches(fp, live) == [("world_size", 2, 1)]
    assert jax_integrity.fingerprint_mismatches(fp, live) == [("world_size", 2, 1)]
    assert integrity.validate_resume(str(path), live) is False
    monkeypatch.setenv("SM_RESUME_STRICT", "true")
    with pytest.raises(exc.UserError, match="world_size"):
        integrity.validate_resume(str(path), live)


# ------------------------------------------- refused before, trained now
@pytest.mark.parametrize("params, named", [
    ({"objective": "rank:ndcg"}, "rank:ndcg"),
    ({"objective": "rank:pairwise"}, "rank:pairwise"),
    ({"objective": "survival:cox"}, "survival:cox"),
    ({"eval_metric": "cox-nloglik"}, "cox-nloglik"),
    ({"booster": "dart"}, "dart"),
    ({"booster": "gblinear"}, "gblinear"),
    ({"process_type": "update"}, "update"),
    ({"tree_method": "approx"}, "approx"),
    ({"tree_method": "exact"}, "exact"),
])
def test_options_refused_across_ranks(ranks, params, named):
    """Only ``tree_method=exact`` is refused across ranks, with the JAX
    package's message; every other option that was refused trains over the
    rank pair, both ranks committing one model and printing one log
    (``tests/test_torch_distributed_options.py`` holds each to the JAX
    mesh)."""
    config = booster.TrainConfig(params)
    if named == "exact":
        with pytest.raises(exc.UserError, match=named) as err:
            booster.refuse_across_ranks(config)
        assert "does not support distributed training (it doesn't in XGBoost either); " \
            "use tree_method='hist'." in str(err.value)
        assert "ROADMAP" not in str(err.value)
        return
    booster.refuse_across_ranks(config)
    i = ur.ONCE_REFUSED.index(params)
    (raw0, log0), (raw1, log1) = (ranks[r]["once refused", i] for r in range(2))
    assert raw0 == raw1, named
    assert log0 == log1 and all(len(v) == 2 for v in log0["train"].values()), named
    # one rank trains them as before
    booster.refuse_across_ranks(booster.TrainConfig({"objective": "binary:logistic"}))


def test_train_refuses_before_any_collective(monkeypatch):
    """``train(group=)`` refuses an option before it binned or gathered
    anything: a fake two-rank group never sees a collective."""
    from sagemaker_xgboost_container_tpu_torch.parallel import collectives

    monkeypatch.setattr(collectives, "world", lambda group: (0, 2))
    monkeypatch.setattr(collectives, "all_gather",
                        lambda *a, **k: pytest.fail("a collective ran"))
    dm = DataMatrix(np.zeros((10, 2), np.float32), labels=np.zeros(10, np.float32))
    with pytest.raises(exc.UserError, match="tree_method='exact'"):
        booster.train({"tree_method": "exact"}, dm, 1, device="cpu", group=object())


def test_one_rank_group_is_the_plain_path():
    """A group of None trains as before: no collective is counted."""
    from sagemaker_xgboost_container_tpu_torch.parallel import collectives

    X, y = ur.case_data("binary")
    collectives.reset_stats()
    booster.train({"max_depth": 3}, DataMatrix(X, labels=y), 2, device="cpu")
    assert collectives.STATS["calls"] == 0
    assert os.environ.get("GRAFT_HIST_COMM") is None
    assert torch.distributed.is_available()
