"""The feature axis of the port, ``train(grid=)`` over a data x feature
grid of process groups, against the JAX package's 2-D ``("data",
"feature")`` mesh and one device.

Two module-scoped suites of spawned CPU gloo ranks train every case once
(``tests/util_torch_ranks.grid_suite``): a 2 x 2 grid (four ranks) and a
1 x 2 feature-only grid (two ranks). Each case is trained on the grid and
over its data group alone (the 1-D data run over the same shards); the
tests hold the grid's models to each other, to that run byte for byte, and
to JAX ``train(mesh=)`` on four of conftest's eight virtual devices
reshaped (2, 2) and on one device. The features are integer-valued, so
every rank's cuts, their merge and the cuts of all rows coincide. The
colsample case replays the JAX package's column draws on every rank.
"""

import concurrent.futures

import numpy as np
import pytest
from jax.sharding import Mesh

import jax
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu_torch.ops import histogram
from sagemaker_xgboost_container_tpu_torch.parallel import grid as grid_mod
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from tests import util_torch_ranks as ur

# leaf values and predictions against the JAX package: the ranks sum their
# histograms in another order than the mesh's psum, an f32 rounding
# difference
VALUE_TOL = 1e-5
TREE_KEYS = ("feature", "threshold", "default_left", "left", "right")


def _replayed_draws(name):
    """The JAX package's column draws of a sampled case, round by round, as
    numpy (tree, level, node) masks: every rank replays them."""
    from tests.test_torch_sampling import JaxReplaySampler

    params, rounds, _kind = ur.GRID_CASES[name]
    X = ur.grid_data(name)[0]
    sampler = JaxReplaySampler(params, X.shape[0], X.shape[1])
    out = []
    for rnd in range(rounds):
        out.append([tuple(None if m is None else m.numpy() for m in draw.masks)
                    for draw in sampler.draw(rnd)])
    return out


def _jax_model(name, mesh):
    params, rounds, _kind = ur.GRID_CASES[name]
    X, y, sizes, _split = ur.grid_data(name)
    xgb_model = None
    if name == "update":
        import tempfile

        path = tempfile.mktemp(suffix=".json")
        with open(path, "wb") as f:
            f.write(ur.update_base_model())
        xgb_model = path
    return jax_booster.train(dict(params), JaxDataMatrix(X, labels=y, groups=sizes),
                             num_boost_round=rounds, mesh=mesh, xgb_model=xgb_model)


@pytest.fixture(scope="module")
def suites():
    """The two rank suites, spawned at once, and, while they train, every
    case's JAX models on the 2 x 2 mesh and on one device -> (the 2 x 2
    grid's results, the 1 x 2 grid's, {(case, "2x2" | "one"): model})."""
    draws = {name: _replayed_draws(name) for name, (_p, _r, kind) in ur.GRID_CASES.items()
             if kind == "colsample"}
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "feature"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        four = pool.submit(ur.run_ranks, ur.grid_suite, (2, draws), 4, 300)
        two = pool.submit(ur.run_ranks, ur.grid_suite, (2, draws), 2, 300)
        models = {}
        for name in ur.GRID_CASES:
            models[name, "2x2"] = _jax_model(name, mesh)
            models[name, "one"] = _jax_model(name, None)
        return four.result(), two.result(), models


@pytest.fixture(scope="module")
def grid4(suites):
    return suites[0]


@pytest.fixture(scope="module")
def grid2(suites):
    return suites[1]


@pytest.fixture(scope="module")
def jax_models(suites):
    return lambda name, where: suites[2][name, where]


def _assert_same_model(arrays, preds, ref, name):
    if isinstance(arrays, dict):      # gblinear
        np.testing.assert_allclose(arrays["weights"], ref.weights, atol=VALUE_TOL)
        np.testing.assert_allclose(arrays["bias"], ref.bias, atol=VALUE_TOL)
    else:
        assert len(arrays) == len(ref.trees), name
        for t, (a, b) in enumerate(zip(arrays, ref.trees)):
            for key in TREE_KEYS:
                assert np.array_equal(a[key], np.asarray(getattr(b, key))), (name, t, key)
            np.testing.assert_allclose(a["value"], b.value, atol=VALUE_TOL, err_msg=name)
    np.testing.assert_allclose(preds, ref.predict(ur.grid_data(name)[0]), atol=VALUE_TOL,
                               err_msg=name)


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("world, F, data, feature", [
    (4, 2, [[0, 2], [1, 3]], [[0, 1], [2, 3]]),
    (4, 1, [[0, 1, 2, 3]], [[0], [1], [2], [3]]),
    (4, 4, [[0], [1], [2], [3]], [[0, 1, 2, 3]]),
    (6, 3, [[0, 3], [1, 4], [2, 5]], [[0, 1, 2], [3, 4, 5]]),
])
def test_plan_grid_lays_ranks_out_as_the_jax_reshape(world, F, data, feature):
    """Rank r sits at data index r // F and feature index r % F, as
    ``devices.reshape(R // F, F)`` places device r."""
    assert grid_mod.plan_grid(world, F) == (data, feature)
    devices = np.arange(world).reshape(world // F, F)
    assert feature == [list(row) for row in devices]
    assert data == [list(col) for col in devices.T]


@pytest.mark.parametrize("world, F, hosts, message", [
    (4, 3, None, "does not divide"),
    (6, 4, None, "does not divide"),
    (4, 0, None, "does not divide"),
    (4, 4, ["a", "a", "b", "b"], "must not span processes"),
    (4, 2, ["a", "b", "a", "b"], "must not span processes"),
])
def test_plan_grid_refusals(world, F, hosts, message):
    with pytest.raises(exc.UserError, match=message):
        grid_mod.plan_grid(world, F, hosts)
    # a feature group within each host is a grid
    grid_mod.plan_grid(4, 2, ["a", "a", "b", "b"])


def test_build_grid_places_every_rank(grid4, grid2):
    assert [r["place"] for r in grid4] == [(s, f, 2, 2, 1) for s in range(2) for f in range(2)]
    assert [r["place"] for r in grid2] == [(0, 0, 1, 2, 1), (0, 1, 1, 2, 1)]


def test_refusals_across_ranks(grid4, grid2):
    for r in grid4 + grid2:
        assert "not both" in r["both"]
        assert "does not divide" in r["undivided"]
    for r in grid4:
        # the faked topology: two hosts of two local ranks
        assert r["spans hosts"].endswith(grid_mod.SPANS_HOSTS_MESSAGE)
        assert r["hosts"] == 2
        assert "tree_method='exact' does not support distributed" in r["exact over hosts"]


# ------------------------------------------------------------ the models
@pytest.mark.parametrize("name", sorted(ur.GRID_CASES))
def test_grid_models_byte_equal_across_ranks_and_to_the_data_run(grid4, name):
    """The four ranks save one model, and it is the 1-D data run's over the
    same two data shards, byte for byte (sampling included)."""
    raws = [r["grid", name][2] for r in grid4]
    assert all(raw == raws[0] for raw in raws), name
    if name == "exact":
        # a 1-D data group refuses exact (each rank a host); the grid of one
        # host trains it with the cuts of all its rows
        assert ("data", name) not in grid4[0]
        return
    assert raws[0] == grid4[0]["data", name][2], name
    assert grid4[0]["data", name][2] == grid4[1]["data", name][2]


@pytest.mark.parametrize("name", ur.FEATURE_ONLY_CASES)
def test_feature_only_grid_equals_one_rank(grid2, name):
    raws = [r["grid", name][2] for r in grid2]
    assert raws[0] == raws[1] == grid2[0]["data", name][2], name


@pytest.mark.parametrize("name", sorted(ur.GRID_CASES))
def test_grid_matches_jax_2d_mesh(grid4, jax_models, name):
    arrays, preds = grid4[0]["grid", name][:2]
    _assert_same_model(arrays, preds, jax_models(name, "2x2"), name)


# "uneven": on its 700 / 303 row split tree 2 holds a near-tie of two
# adjacent thresholds that the order of the sums decides; the JAX package's
# own 2 x 2 mesh takes the other one than its one device there, as the grid
# and the data run do
@pytest.mark.parametrize("name", sorted(set(ur.GRID_CASES) - {"uneven"}))
def test_grid_matches_jax_one_device(grid4, jax_models, name):
    arrays, preds = grid4[0]["grid", name][:2]
    _assert_same_model(arrays, preds, jax_models(name, "one"), name)


@pytest.mark.parametrize("name", ur.FEATURE_ONLY_CASES)
def test_feature_only_grid_matches_jax_one_device(grid2, jax_models, name):
    arrays, preds = grid2[1]["grid", name][:2]
    _assert_same_model(arrays, preds, jax_models(name, "one"), name)


@pytest.mark.parametrize("name", ur.GRID_SCATTER_CASES)
def test_psum_and_reduce_scatter_byte_equal_on_the_grid(grid4, name):
    for r in grid4:
        assert r["grid", name][2] == r["scatter", name][2], name


@pytest.mark.parametrize("name", sorted(set(ur.GRID_CASES) - {"gblinear"}))
def test_staged_bins_are_the_feature_shards_columns(grid4, name):
    """Each grid rank's session holds [n_local, d_pad / F] bins, its padded
    columns always missing; the data run's hold every column."""
    X = ur.grid_data(name)[0]
    d_local = histogram.padded_feature_width(X.shape[1], 2) // 2
    for r in grid4:
        rows = len(ur.grid_shard(name, r["place"][0], 2)[0])
        for shape, dtype, padded_missing in r["grid", name][5]:
            # max_bin 256: 257 bins a feature, the missing one included;
            # exact's 17 (16 distinct values) fit a byte
            want = "torch.uint8" if name == "exact" else "torch.uint16"
            assert shape == (rows, d_local) and dtype == want, (name, shape, dtype)
            assert padded_missing
        for shape, _dtype, _p in r.get(("data", name), ((),) * 6)[5]:
            assert shape == (rows, X.shape[1])


@pytest.mark.parametrize("name", sorted(set(ur.GRID_CASES) - {"gblinear"}))
def test_padded_columns_never_split_on(grid4, name):
    d = ur.grid_data(name)[0].shape[1]
    for tree in grid4[0]["grid", name][0]:
        inner = tree["left"] >= 0
        assert (tree["feature"][inner] < d).all(), name


# ----------------------------------------------------------- the metrics
@pytest.mark.parametrize("name", sorted(ur.GRID_CASES))
def test_metric_lines_equal_the_data_runs(grid4, name):
    """The grid's lines equal on every rank and equal the 1-D data run's:
    the metrics combine over the data group only."""
    logs = [r["grid", name][3] for r in grid4]
    assert all(log == logs[0] for log in logs), name
    if name != "exact":
        assert logs[0] == grid4[0]["data", name][3], name


def test_eval_set_keeps_every_column(grid4):
    log = grid4[0]["grid", "binary"][3]
    assert len(log["validation"]["logloss"]) == ur.GRID_CASES["binary"][1]
    assert log["validation"] == grid4[0]["data", "binary"][3]["validation"]


def test_k_rounds_a_dispatch_on_the_grid(grid4):
    """K = 3 on the grid runs eagerly, with a metric line a round equal to
    K = 1's, and the same model."""
    for r in grid4:
        assert r["dispatch"][3] == r["grid", "binary"][3]
        assert r["dispatch"][2] == r["grid", "binary"][2]


# ------------------------------------------------------- the collectives
def test_round_fields_show_the_grids_traffic_by_kind(grid4):
    """The last round's ``hist_comm_kinds``: the data group's histograms
    and node totals apart from the feature group's split merge and routing,
    each at the bytes ``round_comm_plan`` plans for the grid."""
    params, _rounds, _kind = ur.GRID_CASES["binary"]
    for r in grid4:
        kinds = r["grid", "binary"][4]
        rows = len(ur.grid_shard("binary", r["place"][0], 2)[0])
        entries, _total = histogram.round_comm_plan(
            "depthwise", params["max_depth"], 0, 3, 257, 2, "psum", True,
            feature_shards=2, rows=rows)
        planned = {}
        for e in entries:
            planned[e["kind"]] = planned.get(e["kind"], 0) + e["bytes"]
        assert set(kinds) == {"hist", "totals", "merge", "route"}
        for kind, v in kinds.items():
            assert v["bytes"] == planned[kind], (kind, v, planned)
        # one uint8 decision a row at each of the tree's 4 splitting levels
        assert kinds["route"]["bytes"] == rows * params["max_depth"]
        assert kinds["route"]["calls"] == params["max_depth"]
    # the data run has no feature group
    assert set(grid4[0]["data", "binary"][4]) == {"hist", "totals"}


def test_round_comm_plan_feature_entries():
    """The feature group's entries add to the data axis's plan, which stays
    the JAX package's."""
    base = histogram.round_comm_plan("depthwise", 8, 0, 14, 257, 2, "psum", True)
    entries, total = histogram.round_comm_plan("depthwise", 8, 0, 14, 257, 2, "psum", True,
                                               feature_shards=2, rows=500_000)
    assert entries[:len(base[0])] == base[0]
    extra = entries[len(base[0]):]
    assert all(e["axis"] == "feature" for e in extra)
    route = [e for e in extra if e["kind"] == "route"]
    assert route == [{"kind": "route", "shape": (500_000,), "count": 8, "bytes": 4_000_000.0,
                      "axis": "feature"}]
    assert total == base[1] + 4_000_000 + 7 * 4 * 255
    # a feature-only grid plans its feature entries alone; lossguide routes
    # once a split step
    entries, total = histogram.round_comm_plan("lossguide", 0, 15, 7, 65, 1, "psum", True,
                                               feature_shards=2, rows=100)
    assert [(e["kind"], e["count"]) for e in entries] == [("merge", 1), ("merge", 14),
                                                         ("route", 14)]
    assert total == 7 * 4 * (1 + 2 * 14) + 100 * 14
