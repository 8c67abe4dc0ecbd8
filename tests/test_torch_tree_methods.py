"""Port parity for ``tree_method`` exact and approx on the CPU: the exact cut
selection and its errors, the device lowering of the sketch, ``train()``
with either method (gbtree and dart) against the JAX package, and the
approx re-sketch's cuts round by round.

Trees must be identical in feature / threshold / default_left / child
indices, with leaf values and predictions within 1e-5, on fixtures whose
best gains are well separated; the exact cuts bitwise equal to the JAX
package's, and the approx cuts of every round equal under the same
``GRAFT_SKETCH_IMPL`` on both sides.
"""

import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu.data import binning as jax_binning
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.toolkit import exceptions as jax_exc
from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.data import binning
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import booster
from sagemaker_xgboost_container_tpu_torch.models.booster import TrainConfig
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc


def _columns(n=2000, seed=0):
    """Columns with the awkward cases of a sketch: ties, missing values,
    +-inf, a single value, an all-missing column, and many distinct ones."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 7), np.float32)
    X[:, 0] = rng.randn(n)                          # all distinct
    X[:, 1] = np.round(rng.randn(n), 1)             # heavy ties
    X[:, 2] = rng.randint(0, 9, n)                  # few distinct
    X[:, 3] = np.where(rng.rand(n) < 0.2, np.nan, rng.randn(n))
    X[:, 4] = 7.0                                   # one value
    X[:, 5] = np.nan                                # all missing
    X[:, 6] = rng.randn(n)
    X[:5, 6] = np.inf
    X[5:9, 6] = -np.inf
    X[9:20, 6] = np.nan
    return X


@pytest.mark.parametrize("weighted", [False, True])
def test_exact_cut_points_bitwise_equal_jax(weighted):
    X = _columns()
    w = (np.random.RandomState(1).rand(len(X)) + 0.2).astype(np.float32) if weighted else None
    ours = binning.compute_cut_points(X, w, max_bin=None)
    ref = jax_binning.compute_cut_points(X, w, max_bin=None)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # every adjacent-distinct midpoint of the all-distinct column
    assert len(ours[0]) == len(np.unique(X[:, 0])) - 1
    assert (len(ours[4]), len(ours[5])) == (1, 0)


def test_exact_bin_matrix_equals_jax():
    X = _columns()
    y = np.zeros(len(X), np.float32)
    ours = binning.bin_matrix(DataMatrix(X, y), None, exact_cap=8192)
    ref = jax_binning.bin_matrix(JaxDataMatrix(X, labels=y), None, exact_cap=8192)
    assert ours.max_bin == ref.max_bin == len(np.unique(X[:, 0]))
    assert ours.bins.dtype == ref.bins.dtype == np.uint16
    np.testing.assert_array_equal(ours.bins, ref.bins)


def test_exact_cap_and_u16_errors_match_jax():
    rng = np.random.RandomState(2)
    X = rng.randn(3000, 2).astype(np.float32)
    y = np.zeros(len(X), np.float32)
    with pytest.raises(exc.UserError, match="GRAFT_EXACT_BIN_CAP") as ours:
        binning.bin_matrix(DataMatrix(X, y), None, exact_cap=1000)
    with pytest.raises(jax_exc.UserError) as ref:
        jax_binning.bin_matrix(JaxDataMatrix(X, labels=y), None, exact_cap=1000)
    assert "3000 bins" in str(ours.value) and "3000 bins" in str(ref.value)
    # more distinct values than u16 bins hold, with no cap
    Xw = np.arange(70_000, dtype=np.float32)[:, None]
    yw = np.zeros(len(Xw), np.float32)
    with pytest.raises(exc.AlgorithmError, match="uint16") as ours:
        binning.bin_matrix(DataMatrix(Xw, yw), None)
    with pytest.raises(jax_exc.AlgorithmError) as ref:
        jax_binning.bin_matrix(JaxDataMatrix(Xw, labels=yw), None)
    assert str(ours.value) == str(ref.value)


def test_train_config_tree_methods_match_jax(monkeypatch):
    for params in ({"tree_method": "exact", "sketch_eps": 0.3, "max_bin": 64},
                   {"tree_method": "approx", "sketch_eps": 0.01},
                   {"tree_method": "approx", "sketch_eps": 0.0001},
                   {"tree_method": "approx", "max_bin": 64}):
        ours, ref = TrainConfig(params), jax_booster.TrainConfig(params)
        assert (ours.max_bin, ours.exact_bin_cap) == (ref.max_bin, ref.exact_bin_cap)
    monkeypatch.setenv("GRAFT_EXACT_BIN_CAP", "20000")
    assert TrainConfig({"tree_method": "exact"}).exact_bin_cap == 20000


def test_gpu_hist_refused_with_the_jax_message():
    with pytest.raises(exc.UserError) as ours:
        TrainConfig({"tree_method": "gpu_hist"})
    with pytest.raises(jax_exc.UserError) as ref:
        jax_booster.TrainConfig({"tree_method": "gpu_hist"})
    assert str(ours.value) == str(ref.value)


def _with_impl(monkeypatch, impl, fn, *args):
    monkeypatch.setenv("GRAFT_SKETCH_IMPL", impl)
    try:
        return fn(*args)
    finally:
        monkeypatch.delenv("GRAFT_SKETCH_IMPL")


@pytest.mark.parametrize("max_bin", [16, 64, 256])
def test_device_sketch_matches_jax_device_sketch(max_bin, monkeypatch):
    """The torch device lowering against the JAX package's
    ``_device_cut_points`` (GRAFT_SKETCH_IMPL=device on both): unit weights
    give integer cumulative weights, exact in f32, so the cuts are equal
    bit for bit, at 2,000 rows and at 100 (fewer rows than max_bin 256's
    cuts: the static shapes' small-n edge)."""
    for X in (_columns(), _columns(n=100, seed=3)):
        ours = _with_impl(monkeypatch, "device", binning.compute_cut_points, X, None, max_bin)
        ref = _with_impl(monkeypatch, "device", jax_binning.compute_cut_points, X, None,
                         max_bin)
        host = _with_impl(monkeypatch, "host", binning.compute_cut_points, X, None, max_bin)
        for a, b, c in zip(ours, ref, host):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert (len(ours[4]), len(ours[5])) == (1, 0)
    # every distinct value a representative: a real +inf is one, its cut +inf
    Xi = np.asarray([[0.0], [1.0], [2.0], [np.inf], [np.inf], [np.nan], [1.0], [0.0]],
                    np.float32)
    ours = _with_impl(monkeypatch, "device", binning.compute_cut_points, Xi, None, max_bin)
    ref = _with_impl(monkeypatch, "device", jax_binning.compute_cut_points, Xi, None, max_bin)
    np.testing.assert_array_equal(ours[0], ref[0])
    assert np.isinf(ours[0][-1]) and len(ours[0]) == 3


def test_device_sketch_weighted_matches_jax(monkeypatch):
    """With float weights the f32 cumulative sums of the two lowerings add
    in another order, so a quantile target on the edge may pick the
    neighbouring distinct value: each cut within one distinct-value step of
    the JAX package's, and most equal."""
    X = _columns(n=5000, seed=4)
    w = (np.random.RandomState(5).rand(len(X)) * 0.25).astype(np.float32)
    ours = _with_impl(monkeypatch, "device", binning.compute_cut_points, X, w, 64)
    ref = _with_impl(monkeypatch, "device", jax_binning.compute_cut_points, X, w, 64)
    same = total = 0
    for f, (a, b) in enumerate(zip(ours, ref)):
        assert a.shape == b.shape, f
        vals = np.unique(X[:, f][~np.isnan(X[:, f])])
        step = np.max(np.diff(vals)) if len(vals) > 1 else 0.0
        finite = np.isfinite(a) & np.isfinite(b)
        assert (np.abs(a - b)[finite] <= step).all(), f
        same += int(np.sum(a == b))
        total += len(a)
    assert same >= 0.95 * total


def test_device_apply_matches_jax_device_apply(monkeypatch):
    X = _columns()
    cuts = binning.compute_cut_points(X, None, 64)
    for max_bin in (64, 300):
        ours = _with_impl(monkeypatch, "device", binning.apply_cut_points, X, cuts, max_bin)
        ref = _with_impl(monkeypatch, "device", jax_binning.apply_cut_points, X, cuts, max_bin)
        host = binning.apply_cut_points(X, cuts, max_bin)
        assert ours.dtype == ref.dtype == host.dtype
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(ours, host)


def test_one_stable_sort_orders_as_the_two_key_sort():
    """torch.sort puts NaN after +inf, so a stable sort of the raw values is
    the JAX program's two-key order (value with NaN as +inf, then the
    missing flag): finite ascending, real +inf, then the missing tail."""
    col = np.asarray([np.nan, 3.0, np.inf, -1.0, np.nan, np.inf, -np.inf, 3.0, 0.0],
                     np.float32)
    values, order = torch.sort(torch.as_tensor(col), stable=True)
    nan = np.isnan(col)
    want = np.lexsort((np.arange(len(col)), nan, np.where(nan, np.inf, col)))
    np.testing.assert_array_equal(order.numpy(), want)
    assert np.isnan(values.numpy()[-2:]).all() and np.isinf(values.numpy()[-4:-2]).all()


def test_sketch_impl_auto_takes_the_device_lowering_on_cuda_only(monkeypatch):
    monkeypatch.delenv("GRAFT_SKETCH_IMPL", raising=False)
    assert binning._sketch_impl() == "host"
    assert binning._sketch_impl("cpu") == "host"
    assert binning._sketch_impl(torch.device("cuda", 0)) == "device"
    monkeypatch.setenv("GRAFT_SKETCH_IMPL", "device")
    assert binning._sketch_impl() == "device"
    monkeypatch.setenv("GRAFT_SKETCH_IMPL", "gpu")
    with pytest.raises(ValueError):
        binning._sketch_impl()


def test_exact_matches_bruteforce_greedy():
    """The JAX package's oracle test (tests/test_booster.py) on the port:
    the root split of exact is the brute-force best over every midpoint of
    adjacent distinct values, with more than 256 distinct values."""
    rng = np.random.RandomState(9)
    n = 700
    X = rng.randn(n, 4).astype(np.float32)
    y = (X[:, 0] * 1.5 + np.sin(3 * X[:, 1]) + 0.1 * rng.randn(n)).astype(np.float32)
    forest = train({"tree_method": "exact", "max_depth": 3, "eta": 1.0}, DataMatrix(X, y), 1,
                   device="cpu", verbose_eval=False)
    t = forest.trees[0]
    g = np.full(n, forest.base_score) - y
    best = (-np.inf, None, None)
    G, H = g.sum(), float(n)
    for f in range(X.shape[1]):
        vals = np.unique(X[:, f])
        for lo, hi in zip(vals[:-1], vals[1:]):
            thr = (lo + hi) / 2.0
            m = X[:, f] < thr
            gl, hl = g[m].sum(), m.sum()
            gain = (gl * gl / (hl + 1) + (G - gl) ** 2 / (H - hl + 1) - G * G / (H + 1)) / 2
            if gain > best[0]:
                best = (gain, f, thr)
    assert t.feature[0] == best[1]
    np.testing.assert_allclose(t.threshold[0], best[2], rtol=1e-5)


def _data(n=3000, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, d), 2).astype(np.float32)   # ~500 distinct a feature
    score = 2.0 * X[:, 0] - 1.5 * (X[:, 1] > 0.3) + 0.8 * X[:, 2] * X[:, 3]
    X[rng.rand(n, d) < 0.03] = np.nan
    return X, (score + 0.3 * rng.randn(n) > 0).astype(np.float32)


class _Log:
    def after_iteration(self, forest, rnd, evals_log):
        self.log = evals_log
        return False


def _record_cuts(monkeypatch, session_cls, rounds):
    """Wrap a package's ``_resketch_bins`` to keep the cuts of each round."""
    original = session_cls._resketch_bins

    def recording(self):
        original(self)
        rounds.append([np.asarray(c, np.float32).copy() for c in self.cuts])

    monkeypatch.setattr(session_cls, "_resketch_bins", recording)


def _missing_reaches(tree, X):
    """Per node: does a row of X with a missing value in the node's split
    feature reach it? Elsewhere both placements of the missing bucket score
    the same and ``default_left`` is an f32 rounding tie."""
    out = np.zeros(tree.num_nodes, bool)
    stack = [(0, np.ones(len(X), bool))]
    while stack:
        node, rows = stack.pop()
        if tree.left[node] < 0:
            continue
        v = X[:, tree.feature[node]]
        out[node] = bool(np.isnan(v[rows]).any())
        right = np.where(np.isnan(v), ~tree.default_left[node], v >= tree.threshold[node])
        stack += [(tree.left[node], rows & ~right), (tree.right[node], rows & right)]
    return out


def _assert_same_forest(ours, ref, Xv, X=None):
    """Identical splits (``default_left`` where rows of the training rows X
    with a missing value reach), leaf values and margins within 1e-5."""
    assert len(ours.trees) == len(ref.trees)
    for a, b in zip(ours.trees, ref.trees):
        for key in ("feature", "threshold", "left", "right"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
        decided = np.ones(a.num_nodes, bool) if X is None else _missing_reaches(a, X)
        np.testing.assert_array_equal(a.default_left[decided], b.default_left[decided])
        np.testing.assert_allclose(a.value, b.value, atol=1e-5)
    np.testing.assert_allclose(ours.predict(Xv, output_margin=True),
                               ref.predict(Xv, output_margin=True), atol=1e-5)


METHODS = {
    "exact": {"tree_method": "exact"},
    "exact+lossguide": {"tree_method": "exact", "grow_policy": "lossguide", "max_leaves": 12,
                        "max_depth": 0},
    "approx": {"tree_method": "approx", "max_bin": 32},
    "approx+multiclass": {"tree_method": "approx", "max_bin": 32,
                          "objective": "multi:softprob", "num_class": 3},
    "approx+dart": {"tree_method": "approx", "max_bin": 32, "booster": "dart",
                    "rate_drop": 0.5, "one_drop": 1},
}


@pytest.fixture(scope="module", params=sorted(METHODS))
def trained(request):
    mp = pytest.MonkeyPatch()
    try:
        X, y = _data()
        Xv, yv = _data(n=800, seed=1)
        params = dict({"objective": "binary:logistic", "max_depth": 4, "eta": 0.3,
                       "min_child_weight": 5.0}, **METHODS[request.param])
        if params["objective"] == "multi:softprob":
            y = (X[:, 0] > -0.4).astype(np.float32) + (X[:, 0] > 0.4) * np.float32(1)
            yv = (Xv[:, 0] > -0.4).astype(np.float32) + (Xv[:, 0] > 0.4) * np.float32(1)
        cuts, ref_cuts, logs = [], [], (_Log(), _Log())
        _record_cuts(mp, booster._TrainingSession, cuts)
        _record_cuts(mp, jax_booster._TrainingSession, ref_cuts)
        ours = train(params, DataMatrix(X, y), 4, evals=[(DataMatrix(Xv, yv), "validation")],
                     device="cpu", callbacks=[logs[0]], verbose_eval=False)
        ref = jax_booster.train(params, JaxDataMatrix(X, y), 4,
                                evals=[(JaxDataMatrix(Xv, yv), "validation")],
                                callbacks=[logs[1]], verbose_eval=False)
    finally:
        mp.undo()
    return request.param, ours, ref, logs[0].log, logs[1].log, cuts, ref_cuts, Xv, X


def test_train_tree_method_matches_jax(trained):
    kind, ours, ref, log, ref_log, _, _, Xv, X = trained
    _assert_same_forest(ours, ref, Xv, X)
    for metric, values in ref_log["validation"].items():
        np.testing.assert_allclose(log["validation"][metric], values, atol=1e-5)


def test_approx_cuts_of_every_round_equal_jax(trained):
    """The host sketch on both sides (GRAFT_SKETCH_IMPL auto on the CPU):
    the re-sketch runs before every round, round 0 included, and its cuts
    equal the JAX package's bit for bit and change between rounds."""
    kind, _, _, _, _, cuts, ref_cuts, _, _ = trained
    if not kind.startswith("approx"):
        assert cuts == [] and ref_cuts == []
        return
    assert len(cuts) == len(ref_cuts) == 4
    for ours, ref in zip(cuts, ref_cuts):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(cuts[0], cuts[1]))


def test_exact_bins_are_data_sized(monkeypatch):
    """exact bins at every distinct value: ~500 a feature on the 0.01 grid,
    far past max_bin, and every threshold a midpoint of two grid values."""
    X, y = _data()
    session_bins = []
    original = booster._TrainingSession.__init__

    def spy(self, *a, **kw):
        original(self, *a, **kw)
        session_bins.append(self.num_bins)

    monkeypatch.setattr(booster._TrainingSession, "__init__", spy)
    forest = train({"tree_method": "exact", "max_bin": 16, "max_depth": 4},
                   DataMatrix(X, y), 2, device="cpu", verbose_eval=False)
    assert session_bins == [max(len(np.unique(c[~np.isnan(c)])) for c in X.T) + 1]
    assert session_bins[0] > 400
    thresholds = np.concatenate([t.threshold[t.left >= 0] for t in forest.trees])
    np.testing.assert_allclose(np.abs(np.round(thresholds * 200)) % 2, 1, atol=1e-3)


def test_dart_approx_drops_the_same_sets_as_jax(monkeypatch):
    """The dart loop re-sketches before each round's dropout draw in both
    packages: the same dropped sets, trees and leaf values."""
    X, y = _data(n=1500)

    class Drops:
        def __init__(self):
            self.rounds, self._values = [], []

        def after_iteration(self, model, epoch, evals_log):
            indptr = model.iteration_indptr
            self.rounds.append([u for u in range(len(indptr) - 2) if any(
                not np.array_equal(model.trees[t].value, self._values[t])
                for t in range(indptr[u], indptr[u + 1]))])
            self._values = [t.value.copy() for t in model.trees]
            return False

    params = {"objective": "binary:logistic", "booster": "dart", "tree_method": "approx",
              "max_bin": 32, "max_depth": 4, "rate_drop": 0.6, "one_drop": 1, "seed": 3}
    drops, ref_drops = Drops(), Drops()
    calls = []
    original = booster._TrainingSession._resketch_bins
    monkeypatch.setattr(booster._TrainingSession, "_resketch_bins",
                        lambda self: calls.append(1) or original(self))
    ours = train(params, DataMatrix(X, y), 4, device="cpu", callbacks=[drops],
                 verbose_eval=False)
    ref = jax_booster.train(params, JaxDataMatrix(X, y), 4, callbacks=[ref_drops],
                            verbose_eval=False)
    assert len(calls) == 4
    assert drops.rounds == ref_drops.rounds and sum(map(len, drops.rounds)) > 0
    _assert_same_forest(ours, ref, X, X)


def test_approx_resketch_refreshes_cuts_and_evals():
    """After the JAX package's tests/test_booster.py: the incremental eval
    margins, re-binned at every re-sketch, agree with a fresh predict of
    the final forest (validation logloss within 5e-3)."""
    rng = np.random.RandomState(3)
    X = rng.randn(1500, 5).astype(np.float32)
    y = ((X[:, 0] + 0.3 * X[:, 1] ** 2) > 0.5).astype(np.float32)
    Xv = rng.randn(400, 5).astype(np.float32)
    yv = ((Xv[:, 0] + 0.3 * Xv[:, 1] ** 2) > 0.5).astype(np.float32)
    log = _Log()
    model = train({"tree_method": "approx", "max_bin": 64, "max_depth": 3,
                   "objective": "binary:logistic", "eval_metric": "logloss"},
                  DataMatrix(X, y), 6, evals=[(DataMatrix(X, y), "train"),
                                              (DataMatrix(Xv, yv), "val")],
                  device="cpu", callbacks=[log], verbose_eval=False)
    p = np.clip(model.predict(Xv), 1e-7, 1 - 1e-7)
    fresh = float(-np.mean(yv * np.log(p) + (1 - yv) * np.log(1 - p)))
    assert abs(fresh - log.log["val"]["logloss"][-1]) < 5e-3


def test_approx_resketch_escape_keeps_the_initial_sketch(monkeypatch):
    """GRAFT_APPROX_RESKETCH=0: approx is hist at the same bin budget."""
    X, y = _data(n=1500)
    monkeypatch.setenv("GRAFT_APPROX_RESKETCH", "0")
    a = train({"tree_method": "approx", "max_bin": 32, "max_depth": 4}, DataMatrix(X, y), 3,
              device="cpu", verbose_eval=False)
    h = train({"tree_method": "hist", "max_bin": 32, "max_depth": 4}, DataMatrix(X, y), 3,
              device="cpu", verbose_eval=False)
    _assert_same_forest(a, h, X)


def test_approx_device_lowering_session(monkeypatch):
    """GRAFT_SKETCH_IMPL=device on a CPU session: the re-sketch takes the
    torch lowering, stages the features once and re-bins the eval sets;
    the model trains as the JAX package's device lowering does (cuts from
    f32 cumulative sums on both sides)."""
    monkeypatch.setenv("GRAFT_SKETCH_IMPL", "device")
    X, y = _data(n=1500)
    Xv, yv = _data(n=400, seed=1)
    staged = []
    original = booster._TrainingSession._resketch_bins

    def spy(self):
        original(self)
        staged.append(self._feats_dev)

    monkeypatch.setattr(booster._TrainingSession, "_resketch_bins", spy)
    log = _Log()
    params = {"tree_method": "approx", "max_bin": 32, "max_depth": 4,
              "objective": "binary:logistic"}
    ours = train(params, DataMatrix(X, y), 4, evals=[(DataMatrix(Xv, yv), "val")],
                 device="cpu", callbacks=[log], verbose_eval=False)
    assert len(staged) == 4 and all(s is staged[0] for s in staged)
    ref = jax_booster.train(params, JaxDataMatrix(X, y), 4, verbose_eval=False)
    np.testing.assert_allclose(ours.predict(Xv), ref.predict(Xv), atol=1e-3)
    p = np.clip(ours.predict(Xv), 1e-7, 1 - 1e-7)
    fresh = float(-np.mean(yv * np.log(p) + (1 - yv) * np.log(1 - p)))
    assert abs(fresh - log.log["val"]["logloss"][-1]) < 5e-3


@pytest.mark.cuda
def test_device_sketch_on_cuda_matches_the_cpu_lowering():
    """The device lowering on the card against the same torch ops on the
    CPU: unit weights sum integers, exact in f32 in any order, so the cuts
    and the bins are equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs the re-sketch on the card")
    X = _columns(n=50_000, seed=6)
    w = np.ones(len(X), np.float32)
    got = {}
    for dev in ("cuda", "cpu"):
        feats = torch.as_tensor(X, device=dev)
        mids, n_cuts = binning.device_cut_points(feats, torch.as_tensor(w, device=dev), 255)
        got[dev] = (binning.cut_lists(mids, n_cuts),
                    binning.device_apply(feats, mids, n_cuts, 256).cpu().numpy())
    for a, b in zip(got["cuda"][0], got["cpu"][0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["cuda"][1], got["cpu"][1])
    assert got["cuda"][1].dtype == np.uint16
