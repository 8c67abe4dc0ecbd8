"""Port parity for the ranking objectives (rank:pairwise / rank:ndcg /
rank:map) on the CPU: the group layout, the LambdaMART gradients, the
ndcg / map metrics, ``train()``, the model files and the ``train`` entry
point, each against the JAX package.

Gradients are held to 1e-5 of the largest |g| / |h| (the packages sum the
pairs of a group in another order); metrics and leaf values to 1e-5.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sagemaker_xgboost_container_tpu.data import readers as jax_readers
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models import eval_metrics as jax_eval_metrics
from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest
from sagemaker_xgboost_container_tpu.ops import ranking as jax_ranking
from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import eval_metrics
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.ops import ranking
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.training import algorithm_train

SCHEMES = ("pairwise", "ndcg", "map")
GRAD_TOL = 1e-5


def _groups_case(case, seed=0):
    """(margins, labels, weights, group sizes) of a named case."""
    rng = np.random.RandomState(seed)
    if case == "uneven":
        # size-1 groups and a group with no relevant document among uneven ones
        sizes = np.array([7, 1, 12, 3, 1, 20, 5, 9])
    elif case == "many":
        sizes = rng.randint(1, 9, 300)  # more groups than one 256-group chunk
    else:
        sizes = rng.randint(2, 15, 24)
    n = int(sizes.sum())
    labels = rng.randint(0, 5, n).astype(np.float32)
    if case == "uneven":
        start = int(sizes[:3].sum())
        labels[start:start + sizes[3]] = 0.0
    margins = (rng.randn(n) * 1.5).astype(np.float32)
    if case == "ties":
        margins[:] = 0.5  # round 0: every margin at base_score
    weights = np.ones(n, np.float32)
    if case == "weights":
        weights = (rng.rand(n) * 2 + 0.1).astype(np.float32)
    return margins, labels, weights, sizes


def _jax_grads(margins, labels, weights, sizes, scheme):
    row_index = jax_ranking.build_group_layout(sizes)
    g, h = jax_ranking.lambdarank_grad_hess(
        jnp.asarray(margins), jnp.asarray(labels), jnp.asarray(weights),
        jnp.asarray(row_index), scheme=scheme)
    return np.array(g), np.array(h)


def _ap_of_order(rel_in_order):
    """Average precision of binary relevances listed in rank order."""
    if rel_in_order.sum() == 0:
        return 0.0
    hits = np.cumsum(rel_in_order)
    return float((hits / np.arange(1, len(rel_in_order) + 1) * rel_in_order).sum()
                 / rel_in_order.sum())


def _f64_grads(margins, labels, weights, sizes, scheme):
    """LambdaMART (grad, hess) recomputed group by group in float64 from the
    definitions (the delta of ndcg and map by exchanging the two documents'
    places in the stable descending order of the scores)."""
    g = np.zeros(len(margins))
    h = np.zeros(len(margins))
    start = 0
    for k in sizes:
        rows = np.arange(start, start + k)
        start += k
        S, Y = margins[rows].astype(np.float64), labels[rows].astype(np.float64)
        order = np.argsort(-S, kind="stable")
        rank = np.empty(k, int)
        rank[order] = np.arange(k)
        if scheme == "ndcg":
            gains = np.exp2(Y) - 1.0
            ideal = np.sort(gains)[::-1] / np.log2(2.0 + np.arange(k))
            max_dcg = max(ideal.sum(), 1e-12)
            disc = 1.0 / np.log2(2.0 + rank)
        rel = (Y > 0).astype(np.float64)
        base_ap = _ap_of_order(rel[order]) if scheme == "map" else 0.0
        for i in range(k):
            for j in range(k):
                if not Y[i] > Y[j]:
                    continue
                rho = 1.0 / (1.0 + np.exp(S[i] - S[j]))
                if scheme == "ndcg":
                    delta = abs(gains[i] - gains[j]) * abs(disc[i] - disc[j]) / max_dcg
                elif scheme == "map":
                    swapped = order.copy()
                    swapped[rank[i]], swapped[rank[j]] = j, i
                    delta = abs(_ap_of_order(rel[swapped]) - base_ap)
                else:
                    delta = 1.0
                g[rows[i]] -= rho * delta
                g[rows[j]] += rho * delta
                h[rows[i]] += rho * (1.0 - rho) * delta
                h[rows[j]] += rho * (1.0 - rho) * delta
    w = weights.astype(np.float64)
    return g * w, np.maximum(h, 1e-16) * w


def test_build_group_layout_matches_jax():
    for sizes, cap in (([3, 1, 4, 1, 5], None), ([2, 7, 7, 1], 4), ([9], None)):
        got = ranking.build_group_layout(sizes, cap)
        want = jax_ranking.build_group_layout(sizes, cap)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_bucket_group_layout_covers_every_row_once():
    sizes = np.random.RandomState(4).randint(1, 40, 200)
    blocks = ranking.bucket_group_layout(sizes, pair_budget=3000)
    rows = np.concatenate([b[b >= 0] for b in blocks])
    assert np.array_equal(np.sort(rows), np.arange(sizes.sum()))
    for b in blocks:
        # each block padded to its own largest group, within the budget
        # unless it holds a single group
        assert (b[:, -1] >= 0).any()
        assert len(b) == 1 or b.size * b.shape[1] <= 3000
    # every group stays whole and in row order
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    got = sorted(tuple(r[r >= 0]) for b in blocks for r in b)
    assert got == sorted(tuple(range(s, s + k)) for s, k in zip(starts, sizes))


def _average_precision(scores, rel):
    order = np.argsort(-scores, kind="stable")
    r = rel[order]
    if r.sum() == 0:
        return 0.0
    return float((np.cumsum(r) / np.arange(1, len(r) + 1) * r).sum() / r.sum())


def test_map_exchange_delta_matches_jax_and_brute_force():
    rng = np.random.RandomState(0)
    for trial in range(5):
        m = rng.randint(4, 10)
        scores = rng.randn(3, m).astype(np.float32)
        rel = (rng.rand(3, m) < 0.4).astype(np.float32)
        rel[:, 0] = 1.0
        valid = np.ones((3, m), bool)
        valid[2, m - 2:] = False  # padding in one group
        got = ranking.map_exchange_delta(*(torch.as_tensor(a) for a in (scores, rel, valid)))
        want = jax_ranking.map_exchange_delta(*(jnp.asarray(a) for a in (scores, rel, valid)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        s, r = scores[0], rel[0]
        base = _average_precision(s, r)
        brute = np.zeros((m, m))
        for i in range(m):
            for j in range(m):
                s2 = s.copy()
                s2[i], s2[j] = s[j], s[i]
                brute[i, j] = abs(_average_precision(s2, r) - base)
        mask = r[:, None] != r[None, :]
        assert np.abs(got.numpy()[0] - brute)[mask].max() < 1e-5, trial


@pytest.mark.parametrize("case", ["uneven", "weights", "ties", "many"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_lambdarank_grad_hess_matches_jax(scheme, case):
    """Both packages' f32 gradients against an f64 recomputation from the
    definitions, each within 1e-5 of the largest |g| / |h|, so that a
    failure names the side that drifted; then the port against the JAX
    package, within the same 1e-5."""
    margins, labels, weights, sizes = _groups_case(case)
    want_g, want_h = _jax_grads(margins, labels, weights, sizes, scheme)
    ref_g, ref_h = _f64_grads(margins, labels, weights, sizes, scheme)
    ref_tol = (GRAD_TOL * max(1.0, np.abs(ref_g).max()), GRAD_TOL * max(1.0, np.abs(ref_h).max()))
    assert np.abs(want_g - ref_g).max() <= ref_tol[0], "the JAX package's grad"
    assert np.abs(want_h - ref_h).max() <= ref_tol[1], "the JAX package's hess"
    args = [torch.as_tensor(a) for a in (margins, labels, weights)]
    layouts = {
        # the JAX package's layout and 256-group chunks
        "chunked": ranking.chunk_group_layout(ranking.build_group_layout(sizes)),
        # groups bucketed by size, several blocks
        "bucketed": ranking.bucket_group_layout(sizes, pair_budget=400),
    }
    assert len(layouts["bucketed"]) > 1
    if case == "many":
        assert len(layouts["chunked"]) == 2
    for name, blocks in layouts.items():
        g, h = ranking.lambdarank_grad_hess(
            *args, [torch.as_tensor(b) for b in blocks], scheme=scheme)
        assert g.dtype == h.dtype == torch.float32
        g_tol = GRAD_TOL * max(1.0, np.abs(want_g).max())
        h_tol = GRAD_TOL * max(1.0, np.abs(want_h).max())
        assert np.abs(g.numpy() - ref_g).max() <= ref_tol[0], ("the port's grad", name)
        assert np.abs(h.numpy() - ref_h).max() <= ref_tol[1], ("the port's hess", name)
        assert np.abs(g.numpy() - want_g).max() <= g_tol, name
        assert np.abs(h.numpy() - want_h).max() <= h_tol, name
    if case == "uneven":
        # a size-1 group and a group without a relevant document pull no row
        assert g[7] == 0.0 and g[20:23].abs().max() == 0.0


def test_ranking_objectives_route_through_the_booster():
    from sagemaker_xgboost_container_tpu_torch.models import objectives

    for name in ("rank:pairwise", "rank:ndcg", "rank:map"):
        obj = objectives.create_objective(name)
        assert obj.needs_groups and obj.scheme == name.split(":")[1]
        with pytest.raises(exc.AlgorithmError, match="group"):
            obj.grad_hess(torch.zeros(2), torch.zeros(2), torch.ones(2))
    assert not objectives.create_objective("binary:logistic").needs_groups


@pytest.mark.parametrize("name", ["ndcg", "ndcg@3", "map", "map@5", "ndcg@0"])
def test_ranking_metrics_match_jax(name):
    margins, labels, weights, sizes = _groups_case("uneven", seed=3)
    got = eval_metrics.evaluate(name, margins, labels, weights, groups=sizes)
    want = jax_eval_metrics.evaluate(name, margins, labels, weights, groups=sizes)
    assert got == pytest.approx(want, abs=1e-12)
    # no groups: one group of all rows
    assert eval_metrics.evaluate(name, margins, labels) == pytest.approx(
        jax_eval_metrics.evaluate(name, margins, labels), abs=1e-12)
    # a group without a relevant document scores 1, as in the JAX package
    assert eval_metrics.evaluate(name, margins[:3], np.zeros(3, np.float32),
                                 groups=[3]) == 1.0


def _ranking_data(n_groups=60, size=25, d=6, seed=0):
    """bench.py's BENCH_TASK=ranking relevance at a small size: a strong
    signal in two features, so that best gains are well separated."""
    rng = np.random.RandomState(seed)
    n = n_groups * size
    X = rng.randn(n, d).astype(np.float32)
    rel = X[:, 0] + np.sin(X[:, 1]) + 0.5 * rng.randn(n)
    y = np.digitize(rel, np.quantile(rel, [0.5, 0.75, 0.9, 0.97])).astype(np.float32)
    return X, y, np.full(n_groups, size, np.int64)


class _Log:
    def after_iteration(self, forest, rnd, evals_log):
        self.log = evals_log
        return False


@pytest.fixture(scope="module", params=["rank:pairwise", "rank:ndcg", "rank:map"])
def ranked(request):
    X, y, groups = _ranking_data()
    Xv, yv, gv = _ranking_data(n_groups=20, seed=1)
    params = {"objective": request.param, "max_depth": 3, "max_bin": 32, "eta": 0.3,
              "eval_metric": ["ndcg@10", "map", "ndcg"]}
    log = _Log()
    ours = train(params, DataMatrix(X, y, groups=groups), 3,
                 evals=[(DataMatrix(Xv, yv, groups=gv), "validation")], device="cpu",
                 callbacks=[log], verbose_eval=False)
    ref_log = _Log()
    ref = jax_booster.train(params, JaxDataMatrix(X, y, groups=groups), 3,
                            evals=[(JaxDataMatrix(Xv, yv, groups=gv), "validation")],
                            callbacks=[ref_log], verbose_eval=False)
    return ours, ref, log.log, ref_log.log, Xv


def test_train_ranking_matches_jax(ranked):
    ours, ref, log, ref_log, Xv = ranked
    assert len(ours.trees) == len(ref.trees) == 3
    for a, b in zip(ours.trees, ref.trees):
        for key in ("feature", "threshold", "default_left", "left", "right"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
        np.testing.assert_allclose(a.value, b.value, atol=1e-5)
    np.testing.assert_allclose(ours.predict(Xv), ref.predict(Xv), atol=1e-5)
    for metric in ("ndcg@10", "map", "ndcg"):
        np.testing.assert_allclose(log["validation"][metric], ref_log["validation"][metric],
                                   atol=1e-5)


def test_ranking_models_cross_load(ranked, tmp_path):
    ours, ref, _, _, Xv = ranked
    ours.save_model(str(tmp_path / "port.json"))
    ref.save_model(str(tmp_path / "jax.json"))
    in_jax = JaxForest.load_model(str(tmp_path / "port.json"))
    np.testing.assert_allclose(in_jax.predict(Xv), ours.predict(Xv), atol=1e-5)
    in_port = Forest.load_model(str(tmp_path / "jax.json"), device="cpu")
    np.testing.assert_allclose(in_port.predict(Xv), ref.predict(Xv), atol=1e-5)
    assert in_port.objective_name == ref.objective_name


def test_matrix_without_groups_is_one_group():
    X, y, _ = _ranking_data(n_groups=4, size=30)
    params = {"objective": "rank:ndcg", "max_depth": 2, "max_bin": 16}
    one = train(params, DataMatrix(X, y), 2, device="cpu", verbose_eval=False)
    whole = train(params, DataMatrix(X, y, groups=[len(y)]), 2, device="cpu",
                  verbose_eval=False)
    np.testing.assert_array_equal(one.predict(X), whole.predict(X))


def test_ranking_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    X, y, groups = _ranking_data(n_groups=4, size=10)
    with pytest.raises(exc.UserError, match="cpu"):
        train({"objective": "rank:ndcg"}, DataMatrix(X, y, groups=groups), 1)


# --- the train entry point: a libsvm channel with qid: tokens ----------------

METRIC_LINE = re.compile(r"^\[(\d+)\]\t(.*)$")


def _write_qid_channel(path, X, y, groups, sidecar=False):
    """A libsvm channel whose groups are qid: tokens, or (``sidecar``) a
    ``data.libsvm.group`` file of group sizes."""
    os.makedirs(path)
    qid = np.repeat(np.arange(len(groups)), groups)
    with open(os.path.join(path, "data.libsvm"), "w") as f:
        for label, q, row in zip(y, qid, X):
            f.write(" ".join(["{:g}".format(label)] + ([] if sidecar else ["qid:{}".format(q)])
                             + ["{}:{!r}".format(j, float(v)) for j, v in enumerate(row)])
                    + "\n")
    if sidecar:
        np.savetxt(os.path.join(path, "data.libsvm.group"), groups, fmt="%d")


def _entry_lines(package, hp, channel, train_path, val_path, model_dir, capsys):
    """sagemaker_train of one package -> {round: {key: value}} of its lines."""
    import importlib

    kw = dict(train_config=dict(hp), data_config={"train": channel, "validation": dict(channel)},
              train_path=train_path, val_path=val_path, model_dir=model_dir,
              sm_hosts=["algo-1"], sm_current_host="algo-1", checkpoint_config={})
    capsys.readouterr()
    if package == "port":
        algorithm_train.sagemaker_train(device="cpu", **kw)
    else:
        kw["train_config"]["_num_devices"] = "1"
        importlib.import_module(
            "sagemaker_xgboost_container_tpu.training.algorithm_train").sagemaker_train(**kw)
    lines = {}
    for line in capsys.readouterr().out.splitlines():
        m = METRIC_LINE.match(line)
        if m:
            lines[int(m.group(1))] = dict(
                (k, float(v)) for k, v in (p.split(":") for p in m.group(2).split("\t")))
    return lines


@pytest.fixture
def _private_jax_staging(tmp_path, monkeypatch):
    stage = jax_readers.stage_input_files
    monkeypatch.setattr(jax_readers, "stage_input_files",
                        lambda path: stage(path, staging_dir=str(tmp_path / "jax_stage")))


@pytest.mark.parametrize("objective", ["rank:pairwise", "rank:map"])
def test_sagemaker_train_prints_the_jax_metric_lines(objective, tmp_path, capsys,
                                                     _private_jax_staging):
    X, y, groups = _ranking_data(n_groups=40, size=20)
    Xv, yv, gv = _ranking_data(n_groups=10, size=20, seed=1)
    X, Xv = np.round(X, 4), np.round(Xv, 4)
    _write_qid_channel(str(tmp_path / "train"), X, y, groups)
    _write_qid_channel(str(tmp_path / "validation"), Xv, yv, gv)
    channel = {"ContentType": "text/libsvm", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    hp = {"num_round": "4", "max_depth": "3", "max_bin": "32", "eta": "0.3",
          "objective": objective, "eval_metric": "ndcg@5,map@10,ndcg"}
    lines = {package: _entry_lines(package, hp, channel, str(tmp_path / "train"),
                                   str(tmp_path / "validation"), str(tmp_path / package),
                                   capsys)
             for package in ("port", "jax")}
    # both packages default to 8 rounds a dispatch here (no checkpoints) and
    # evaluate host metrics (ndcg, map) at the end of each dispatch only:
    # the 4 rounds print one line, the last round's
    assert sorted(lines["port"]) == sorted(lines["jax"]) == [3]
    for rnd, values in lines["jax"].items():
        assert sorted(lines["port"][rnd]) == sorted(values)
        assert "validation-ndcg@5" in values and "validation-map@10" in values
        for key, value in values.items():
            assert abs(lines["port"][rnd][key] - value) <= 1e-5, (rnd, key)


@pytest.mark.parametrize("metric,maximize", [("ndcg@10", True), ("map@5", True), ("ndcg", True),
                                             ("rmse", False)])
def test_early_stopping_on_a_cut_ranking_metric_maximizes(metric, maximize, tmp_path):
    from sagemaker_xgboost_container_tpu_torch.training import callbacks

    _, _, cbs = callbacks.get_callbacks(
        model_dir=str(tmp_path), checkpoint_dir=None, early_stopping_data_name="validation",
        early_stopping_metric=metric, early_stopping_rounds=3,
        save_model_on_termination="false", is_master=True)
    # every callback but the watchdog and RoundTimer is wrapped in a _TimedCallback
    (stopper,) = [cb.inner for cb in cbs
                  if isinstance(getattr(cb, "inner", None), callbacks.EarlyStopping)]
    assert stopper.maximize is maximize


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", SCHEMES)
def test_ranking_gradients_on_cuda_match_cpu(scheme):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this check on the card")
    margins, labels, weights, sizes = _groups_case("many")
    blocks = ranking.bucket_group_layout(sizes, pair_budget=4000)
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = [t.cpu().numpy() for t in ranking.lambdarank_grad_hess(
            *(torch.as_tensor(a, device=dev) for a in (margins, labels, weights)),
            [torch.as_tensor(b, device=dev) for b in blocks], scheme=scheme)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert np.abs(got - want).max() <= GRAD_TOL * max(1.0, np.abs(want).max())


def test_group_sidecars_reach_training_and_validation(tmp_path, capsys):
    """The same groups as qid: tokens or as .group sidecar files train the
    same model and print the same lines."""
    X, y, groups = _ranking_data(n_groups=30, size=15)
    groups = np.array([10, 20] * 15)  # uneven, same rows
    Xv, yv, gv = _ranking_data(n_groups=10, size=15, seed=1)
    channel = {"ContentType": "text/libsvm", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    # one round a dispatch, so that the host metrics (ndcg, map) print a
    # line every round for the comparison below
    hp = {"num_round": "3", "max_depth": "3", "max_bin": "32", "objective": "rank:ndcg",
          "eval_metric": "ndcg@5,map", "_rounds_per_dispatch": "1"}
    lines = {}
    for kind in ("qid", "sidecar"):
        root = tmp_path / kind
        _write_qid_channel(str(root / "train"), X, y, groups, sidecar=kind == "sidecar")
        _write_qid_channel(str(root / "validation"), Xv, yv, gv, sidecar=kind == "sidecar")
        lines[kind] = _entry_lines("port", hp, channel, str(root / "train"),
                                   str(root / "validation"), str(root / "model"), capsys)
    assert sorted(lines["qid"]) == [0, 1, 2] and lines["qid"] == lines["sidecar"]
    # one group of all rows gives other lines: the groups did reach training
    one = tmp_path / "one"
    _write_qid_channel(str(one / "train"), X, y, [len(y)], sidecar=True)
    _write_qid_channel(str(one / "validation"), Xv, yv, gv, sidecar=True)
    assert _entry_lines("port", hp, channel, str(one / "train"), str(one / "validation"),
                        str(one / "model"), capsys) != lines["qid"]


def test_csv_channel_is_one_group_per_matrix(tmp_path, capsys, _private_jax_staging):
    X, y, _ = _ranking_data(n_groups=6, size=40)
    Xv, yv, _ = _ranking_data(n_groups=2, size=40, seed=1)
    for name, A, b in (("train", X, y), ("validation", Xv, yv)):
        os.makedirs(str(tmp_path / name))
        np.savetxt(str(tmp_path / name / "data.csv"), np.column_stack([b, np.round(A, 4)]),
                   delimiter=",", fmt="%.4f")
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    hp = {"num_round": "3", "max_depth": "3", "max_bin": "32", "objective": "rank:pairwise",
          "eval_metric": "map,ndcg@10"}
    lines = {package: _entry_lines(package, hp, channel, str(tmp_path / "train"),
                                   str(tmp_path / "validation"), str(tmp_path / package),
                                   capsys)
             for package in ("port", "jax")}
    # both packages batch 8 rounds a dispatch here and evaluate the host
    # metrics once a dispatch: one line, the last round's
    assert sorted(lines["port"]) == sorted(lines["jax"]) == [2]
    for rnd, values in lines["jax"].items():
        for key, value in values.items():
            assert abs(lines["port"][rnd][key] - value) <= 1e-5, (rnd, key)

