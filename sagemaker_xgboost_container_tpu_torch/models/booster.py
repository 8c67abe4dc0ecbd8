"""The boosting engine: ``train()``, the counterpart of ``xgb.train``.

One device, eager PyTorch (the gbtree booster here; dart, gblinear and
``process_type=update`` in ``models/dart``, ``models/gblinear`` and
``models/update``): each round computes the objective's grad/hess
(LambdaMART gradients over the query groups for the ranking objectives,
``ops/ranking``), grows ``num_parallel_tree`` trees, or that many per class
for a multiclass objective, all C in one loop (``ops/tree_build.build_tree``
level by level, or ``ops/lossguide.build_tree_lossguide`` split by split,
on [C, n] gradients), adds the trees' row outputs to the training margins
([n] or [n, C]) and their predictions to every eval set's margins,
evaluates the eval metrics (on the device where the metric has a device
form, else on the host) and the ``feval``, and commits the compacted trees
to the Forest. Row and column sampling multiply the gradients by a row keep
mask and the split scan by feature masks, drawn each round by
``models/sampling``. The only host work per round is pulling the trees'
small node arrays and the metric scalars.

``_rounds_per_dispatch`` K, the JAX package's fused dispatch: a dispatch
enqueues K rounds and copies their trees, per-round device metrics and
learning stats to the host once; the rounds then commit one at a time. On
one CUDA rank the round body is captured once a session as a CUDA graph and
replayed (``models/round_graph``); elsewhere the K rounds run eagerly.
Metrics that cannot ride the copy (a feval, a metric without a device form,
a ranking objective) are evaluated on the host once a dispatch, at its last
round, as in the JAX package; a dispatch never builds past the last round
asked for, so that evaluation sees the committed forest.

Callback protocol mirrors xgboost's (before_training / after_iteration ->
bool stop / after_training), which is how early stopping hooks in.

The training planes of the JAX package's gbtree round, env-gated and inert
by default: with ``SM_MODEL_TELEMETRY`` the round computes the learning
stats (``learning_stats``, torch reductions) and brings them to the host in
the round's one copy, the loop emits ``training.learning`` and aborts with
exit 87 on a poisoned round, and the session captures the drift baseline;
with ``SM_DEVICE_TELEMETRY`` the first dispatch's counted kernel work becomes
the ``training.compiled`` record; ``SM_TRACE_DEVICE_SYNC=N`` fences every
N-th dispatch into ``host_dispatch`` / ``device_sync`` phases. A dispatch
that starts while the tracer records (``SM_TRACE``, or a ``torch.profiler``
session: ``telemetry/tracing.recording``) is traced: its rounds stamp their
five stages on the card into a row a round (``ops/stamps``; a captured
graph is captured again when that arming flips), the rows ride its one copy
to the host and become the tracer's ``round.<stage>`` spans and each round's
``device.<stage>`` phases, and the session's leaves are tracer spans and
profiler ranges, not phases (``session.enqueue`` and ``session.copy_out`` a
dispatch, ``session.commit``, ``session.eval`` and ``session.callbacks`` a
round, the last ending before the callback that closes the round);
otherwise each of those sites costs one boolean test. A CUDA
out-of-memory error inside a round dumps forensics and exits 86. The dart
loop builds the same session (so it captures the baseline) but, as in the
JAX package, emits no learning records; gblinear, update and fold-parallel
CV emit none.

Data-parallel training, the JAX package's ``train(..., mesh=)``:
``train(..., group=)`` takes a ``torch.distributed`` process group, one
process a rank, each rank passing its own rows. Every rank bins with the
same cuts (``merged_distributed_cuts``: each rank's candidates gathered and
re-selected), every level's histograms are reduced over the group before
the split scan (``ops/tree_build``, ``ops/lossguide``), the learning stats
are reduced as the JAX round reduces them, and the metric lines combine
every rank's partial statistics, summed in f64 on the host, so every rank
grows the same trees and prints the same lines. Across ranks,
``tree_method=approx`` merges every rank's hessian-weighted candidates each
round, ``survival:cox`` and ``cox-nloglik`` compute on the gathered global
rows (``GlobalRows``), a ranking objective's ranks each own whole query
groups, and dart, gblinear and ``process_type=update`` take the group too;
``tree_method=exact`` raises ``UserError`` across hosts
(``refuse_across_ranks``). The local ranks of one host (one process a GPU,
``parallel/local.py``) bin with their host's cuts instead of a merge: the
leader's sketch of all the host's rows (``local.host_cuts``), so that one
host's ranks bin as the JAX one-host mesh does, exact included.

The feature axis, the JAX package's ``train(mesh=)`` over a ``("data",
"feature")`` mesh: ``train(..., grid=)`` takes a ``parallel/grid.Grid``.
Every collective over rows runs over its data group, as above; each rank
bins all its rows' columns with the data group's merged cuts and keeps only
its feature shard's slice of them on the device (the columns padded to a
multiple of the feature shards with always-missing ones), and the builders
merge the split winners and route the rows over the feature group
(``ops/tree_build``). Eval sets keep every column. gblinear and
``process_type=update`` train on the data group with every column, as the
JAX package's read only the mesh's data axis; dart grows its trees on the
grid. A grid on one host trains ``tree_method=exact`` with the cuts of the
union of its data shards' distinct values (``merged_exact_cuts``), the cuts
of all its rows; a grid over hosts refuses it.

Pre-binned input, the JAX package's: ``train`` takes a ``BinnedMatrix``
(the streaming ingest's, ``data/streaming.py``) as the training matrix and
as eval sets. The session then skips its sketch and binning (and, across
ranks, the merged-cut gather: the ingest agreed the cuts), refuses a
``max_bin`` other than the ingest's, refuses an eval set binned with other
cuts, keeps approx's first sketch, and rebuilds a resumed forest's margins
from ``rep_block`` blocks of representative values. gblinear, dart and
``process_type=update`` need the floats and raise ``UserError``.
"""

import collections
import contextlib
import logging
import os

import numpy as np
import torch

from .._device import resolve_device
from ..data.binning import (
    BinnedMatrix,
    _sketch_impl,
    apply_cut_points,
    bin_matrix,
    compute_cut_points,
    cut_lists,
    device_apply,
    device_cut_points,
    pad_cut_points,
)
from ..ops.lossguide import build_tree_lossguide
from ..ops.predict import forest_leaf_values
from ..ops.ranking import bucket_group_layout, lambdarank_grad_hess
from ..ops.split import shard_feature_slice
from ..ops.stamps import FIRST, GRADIENT, STAGES, StageClock
from ..ops.histogram import hist_comm_impl, padded_feature_width
from ..ops.tree_build import build_tree, pack_tree, predict_binned, unpack_tree
from ..parallel import collectives, local
from ..telemetry import active_recorder, span, tracing
from ..telemetry import model as model_telemetry
from ..telemetry.tracing import DEVICE_SYNC_ENV
from ..toolkit import exceptions as exc
from ..utils.envconfig import env_int
from ..utils.faults import fault_point
from . import eval_metrics
from .device_metrics import make_device_metric
from .forest import Forest, compact_padded_tree
from .objectives import SoftprobMulti, create_objective
from .round_graph import RoundGraph, capture_decision
from .sampling import Sampler

# objective hyperparameters carried into the saved model
OBJECTIVE_PARAM_KEYS = (
    "scale_pos_weight",
    "tweedie_variance_power",
    "huber_slope",
    "max_delta_step",
    "num_class",
    "aft_loss_distribution",
    "aft_loss_distribution_scale",
)
# trees traversed together when a resumed run rebuilds its margins
_RESUME_TREES_PER_PASS = 64
# rows of representative values a block when a pre-binned matrix's margins
# are rebuilt (BinnedMatrix.rep_block)
_REP_BLOCK_ROWS = 1 << 16

logger = logging.getLogger(__name__)

# One dispatch's rounds on the host: ``trees``, per round the list of its
# host tree dicts (one per parallel tree); ``metrics``, the per-round device
# metric values [k, n_sets, n_metrics] or None; ``stages``, per round the
# stage clock's row [k, len(STAGES) + 2] (int64 ns, ``ops/stamps``) or None
Dispatch = collections.namedtuple("Dispatch", ["trees", "metrics", "stages"])
# a session leaf while the tracer does not record
_UNTRACED = contextlib.nullcontext()


def _after_iteration(session, callbacks, forest, rnd, evals_log):
    """The callbacks' ``after_iteration`` in order -> their stop flags. Those
    before the first one that closes the round (``closes_round``: RoundTimer,
    which drains the round's phases and rotates its root span) run inside
    the ``session.callbacks`` leaf; that one and any after it run outside,
    so the leaf never encloses the next round's root span."""
    due = [cb for cb in callbacks if hasattr(cb, "after_iteration")]
    cut = next((i for i, cb in enumerate(due) if getattr(cb, "closes_round", False)), len(due))
    with session.phase("session.callbacks"):
        stops = [cb.after_iteration(forest, rnd, evals_log) for cb in due[:cut]]
    return stops + [cb.after_iteration(forest, rnd, evals_log) for cb in due[cut:]]


def learning_stats(g, h, margins):
    """The round's learning stats, f32 [8] in ``DEVICE_STAT_FIELDS`` order
    (telemetry/model.py), as the JAX package's ``_learning_stats``
    reduces them: sums and extrema of the finite gradients and hessians,
    and the NaN/Inf counts of the gradients and of the updated margins.
    Read-only reductions: nothing here feeds the tree build."""
    gv, hv, mv = g.reshape(-1), h.reshape(-1), margins.reshape(-1)
    g_fin, h_fin = torch.isfinite(gv), torch.isfinite(hv)
    # a Python scalar, not a tensor: a CUDA tensor made from a host value is
    # a host-to-device copy, a sync on the round path
    inf = float("inf")
    return torch.stack([
        torch.where(g_fin, gv, 0.0).sum(),
        torch.where(g_fin, gv, inf).min(),
        torch.where(g_fin, gv, -inf).max(),
        torch.where(h_fin, hv, 0.0).sum(),
        torch.where(h_fin, hv, inf).min(),
        torch.where(h_fin, hv, -inf).max(),
        (~g_fin).sum().float(),
        (~torch.isfinite(mv)).sum().float(),
    ]).float()


class TrainConfig:
    """Parsed + defaulted booster parameters of the ported slice.

    Takes every key that ``algorithm.hyperparameters`` validates and every
    objective (``num_class`` >= 2 for multiclass), with depthwise or
    lossguide growth (``max_leaves`` set; ``max_depth`` 0 only there), row
    and column sampling (``subsample``, ``colsample_bytree``,
    ``colsample_bylevel``, ``colsample_bynode``, drawn from ``seed``),
    bagged rounds (``num_parallel_tree``), the three boosters (``booster``
    gbtree, dart, gblinear) and ``process_type`` default or update. Keys
    that do not change the model being trained (``predictor``, ``nthread``,
    ``verbosity``, the dart knobs under gbtree, ...) are accepted and
    ignored, as the JAX package ignores them there. ``tree_method`` exact
    bins at every distinct value (``max_bin`` None, sized by the data up to
    ``GRAFT_EXACT_BIN_CAP``, default 8192) and approx re-sketches the cuts
    from the hessians before every round; ``monotone_constraints`` and
    ``interaction_constraints`` constrain the gbtree builders, as the JAX
    package's do. What the port does not train raises ``UserError`` naming
    the parameter, rather than training something else: ``gpu_hist``, with
    the JAX package's message.
    """

    def __init__(self, params):
        p = dict(params or {})
        self.eta = float(p.get("eta", 0.3))
        max_depth = p.get("max_depth", 6)
        self.max_depth = int(max_depth) if max_depth is not None else 6
        self.grow_policy = p.get("grow_policy", "depthwise")
        self.max_leaves = int(p.get("max_leaves", 0) or 0)
        if self.grow_policy == "lossguide" and self.max_leaves <= 0:
            # xgboost's 0 means unlimited; the builder's node slots need a bound
            raise exc.UserError("grow_policy='lossguide' requires max_leaves >= 2")
        if self.max_depth < 1 and not (self.grow_policy == "lossguide" and self.max_depth == 0):
            raise exc.UserError(
                "max_depth must be >= 1 for grow_policy='depthwise'; max_depth=0 "
                "(unlimited depth) needs grow_policy='lossguide' with max_leaves"
            )
        # routing passes that take a row to its leaf in any tree
        self.predict_depth = (
            (self.max_depth if self.max_depth > 0 else self.max_leaves - 1)
            if self.grow_policy == "lossguide"
            else self.max_depth
        )
        self.reg_lambda = float(p.get("lambda", 1.0))
        self.alpha = float(p.get("alpha", 0.0))
        self.gamma = float(p.get("gamma", 0.0))
        self.min_child_weight = float(p.get("min_child_weight", 1.0))
        self.max_delta_step = float(p.get("max_delta_step", 0.0))
        self.tree_method = p.get("tree_method", "auto")
        self.exact_bin_cap = None
        if self.tree_method == "exact":
            # hist with cuts at every adjacent distinct-value midpoint: the
            # candidate splits and thresholds of xgboost's exact greedy
            # enumeration. The width is sized by the data at binning time,
            # bounded by the cap; max_bin and sketch_eps do not apply
            self.max_bin = None
            self.exact_bin_cap = int(os.environ.get("GRAFT_EXACT_BIN_CAP", 8192))
        elif p.get("max_bin") is not None:
            self.max_bin = int(p["max_bin"])
        elif p.get("sketch_eps"):
            # bins ~ 1/eps, the JAX package's reading of sketch_eps
            self.max_bin = int(min(max(1.0 / float(p["sketch_eps"]), 2), 1024))
        else:
            self.max_bin = 256
        if self.tree_method == "gpu_hist":
            raise exc.UserError(
                "tree_method 'gpu_hist' is not available in the TPU container; use 'hist'."
            )
        self.monotone_constraints = p.get("monotone_constraints")
        self.interaction_constraints = p.get("interaction_constraints")
        self.seed = int(p.get("seed", 0))
        self.subsample = float(p.get("subsample", 1.0))
        self.colsample_bytree = float(p.get("colsample_bytree", 1.0))
        self.colsample_bylevel = float(p.get("colsample_bylevel", 1.0))
        self.colsample_bynode = float(p.get("colsample_bynode", 1.0))
        self.num_parallel_tree = int(p.get("num_parallel_tree", 1) or 1)
        # internal: boosting rounds a device dispatch (the session may force
        # it to 1, and decides whether they replay from a CUDA graph)
        self.rounds_per_dispatch = int(p.get("_rounds_per_dispatch", 1) or 1)
        self.objective = p.get("objective", "reg:squarederror")
        self.num_class = int(p.get("num_class", 0) or 0)
        self.base_score = float(p.get("base_score", 0.5))
        self.eval_metric = p.get("eval_metric")
        self.booster = p.get("booster", "gbtree")
        self.process_type = p.get("process_type", "default")
        if self.process_type not in ("default", "update"):
            raise exc.UserError(
                "process_type must be 'default' or 'update', got {!r}".format(self.process_type)
            )
        self.objective_params = p
        if self.objective == "count:poisson" and "max_delta_step" not in p:
            self.max_delta_step = 0.7

        unsupported = []
        checks = (
            ("grow_policy", "depthwise", lambda v: v in ("depthwise", "lossguide")),
            ("tree_method", "auto", lambda v: v in ("auto", "hist", "exact", "approx")),
            ("booster", "gbtree", lambda v: v in ("gbtree", "dart", "gblinear")),
        )
        for key, default, ok in checks:
            if not ok(p.get(key, default)):
                unsupported.append("{}={!r}".format(key, p[key]))
        if unsupported:
            raise exc.UserError(
                "not supported by the PyTorch port yet: {}".format(", ".join(unsupported))
            )


def constraint_tensors(config, d, device):
    """(monotone i32 [d] or None, interaction sets bool [S, d] or None) of
    ``config``'s constraints over ``d`` features, as the JAX package lays
    them out: monotone values past the given ones are 0, and set members
    outside [0, d) are dropped."""
    monotone = interaction_sets = None
    if config.monotone_constraints:
        mono = np.zeros(d, np.int32)
        vals = np.asarray(config.monotone_constraints, np.int32)
        mono[:len(vals)] = vals
        monotone = torch.as_tensor(mono, device=device)
    if config.interaction_constraints:
        sets = np.zeros((len(config.interaction_constraints), d), bool)
        for i, members in enumerate(config.interaction_constraints):
            for f in members:
                if 0 <= int(f) < d:
                    sets[i, int(f)] = True
        interaction_sets = torch.as_tensor(sets, device=device)
    return monotone, interaction_sets


def refuse_across_ranks(config):
    """Raise ``UserError`` for the one option that does not train across
    ranks, ``tree_method=exact``, with the JAX package's message: its cuts
    are every distinct value of the rows, which no rank sees all of
    (libxgboost's exact updater is single-machine too)."""
    if config.tree_method == "exact":
        raise exc.UserError(
            "tree_method='exact' does not support distributed training (it doesn't in "
            "XGBoost either); use tree_method='hist'."
        )


def merge_cut_candidates(mats, counts, width):
    """Every rank's cut candidates -> the merged cuts, the JAX package's
    ``_merged_distributed_cuts`` merge: per feature the sorted union of the
    finite candidates, thinned to ``width`` evenly spaced picks when
    longer. ``mats`` [P, d, width] f32 (NaN past each count), ``counts``
    [P, d]. Deterministic: identical inputs give identical cuts on every
    rank."""
    merged = []
    for f in range(mats.shape[1]):
        cands = np.concatenate([mats[p, f, :counts[p, f]] for p in range(mats.shape[0])])
        cands = np.unique(cands[np.isfinite(cands)])
        if len(cands) > width:
            picks = np.linspace(0, len(cands) - 1, width).round().astype(int)
            cands = cands[np.unique(picks)]
        merged.append(cands.astype(np.float32))
    return merged


def candidate_matrix(cuts, width):
    """One rank's cut lists -> (f32 [d, width] candidates, NaN past each
    count; i32 [d] counts): what ``merged_distributed_cuts`` gathers."""
    mat = np.full((len(cuts), width), np.nan, np.float32)
    counts = np.zeros(len(cuts), np.int32)
    for f, c in enumerate(cuts):
        c = np.asarray(c, np.float32)
        mat[f, :len(c)] = c
        counts[f] = len(c)
    return mat, counts


def gather_merged_cuts(mat, counts, group, width, kind):
    """This rank's candidates (f32 [d, width], NaN past each count; [d]
    counts; tensors on the group's device) gathered over ``group`` and
    merged on the host (``merge_cut_candidates``) -> the merged cut lists,
    the same on every rank."""
    mats = collectives.all_gather(mat, group, kind=kind).cpu().numpy()
    all_counts = collectives.all_gather(counts, group, kind=kind).cpu().numpy()
    return merge_cut_candidates(mats, all_counts, width)


def merged_exact_cuts(dtrain, group, device):
    """``tree_method=exact``'s cuts over every rank's rows of ``group``:
    each rank's distinct values a feature gathered, and the cuts of their
    union, which are the midpoints of all the rows' adjacent distinct
    values, as ``compute_cut_points(..., max_bin=None)`` of all the rows
    selects them."""
    from ..data.binning import _select_cuts

    feats = np.asarray(dtrain.features, np.float32)
    distinct = [np.unique(col[~np.isnan(col)]) for col in feats.T]
    longest = max((len(v) for v in distinct), default=0)
    width = max(1, int(collectives.host_all_gather(np.asarray([longest], np.int64), group,
                                                   device).max()))
    mat, counts = candidate_matrix(distinct, width)
    mats = collectives.all_gather(torch.as_tensor(mat, device=device), group,
                                  kind="setup").cpu().numpy()
    all_counts = collectives.all_gather(torch.as_tensor(counts, device=device), group,
                                        kind="setup").cpu().numpy()
    cuts = []
    for f in range(mats.shape[1]):
        union = np.unique(np.concatenate(
            [mats[p, f, :all_counts[p, f]] for p in range(mats.shape[0])]))
        cuts.append(_select_cuts(union, np.ones(len(union), np.float32), max(len(union), 1)))
    return cuts


def merged_distributed_cuts(dtrain, max_bin, group, device, weights=None):
    """Each rank's quantile cuts of its own rows, gathered over ``group``
    and merged, so that every rank bins with the same thresholds: the JAX
    package's ``_merged_distributed_cuts``. ``weights``: sketch weights in
    place of the rows' own (the approx re-sketch passes the current
    hessians)."""
    kind = "setup" if weights is None else "cuts"
    if weights is None:
        weights = dtrain.weights
    width = max_bin - 1
    mat, counts = candidate_matrix(
        compute_cut_points(dtrain.features, weights, max_bin, device=device), width)
    return gather_merged_cuts(torch.as_tensor(mat, device=device),
                              torch.as_tensor(counts, device=device), group, width, kind)


class GlobalRows:
    """Every rank's rows of one matrix, gathered in rank order over
    ``group``: the global rows that the Cox risk sets and ``cox-nloglik``
    need (the JAX package's ``_agreed_pad`` and ``all_gather``). The ranks
    agree on one padded row count, the largest; each pads its own rows to
    it, and the padding carries label 0 and weight 0, so it drops out of
    every cumulative sum (ranks may hold uneven shards, ``ShardedByS3Key``,
    and a gather needs equal shapes). Labels and weights are gathered once;
    each round gathers the margins only."""

    def __init__(self, labels, weights, group, device):
        self.group, self.device = group, device
        self.n = int(len(labels))
        counts = collectives.host_all_gather(np.asarray([self.n], np.int64), group, device)
        self.n_max = int(counts.max())
        self.offset = collectives.world(group)[0] * self.n_max
        self.labels = self.gather(labels, kind="setup")
        self.weights = self.gather(weights, kind="setup")

    def gather(self, x, kind="rows"):
        """This rank's [n, ...] -> the global [P * n_max, ...] on the device."""
        x = torch.as_tensor(x, device=self.device)
        if self.n_max > self.n:
            x = torch.cat([x, x.new_zeros((self.n_max - self.n,) + tuple(x.shape[1:]))])
        every = collectives.all_gather(x, self.group, kind=kind)
        return every.reshape((-1,) + tuple(x.shape[1:]))

    def own(self, x):
        """This rank's segment of a global [P * n_max, ...] tensor."""
        return x[self.offset:self.offset + self.n]

    def grad_hess(self, objective, margins):
        """The objective's (g, h) of this rank's rows, computed on the
        global rows (the JAX package's ``cox_mesh_grad_hess``)."""
        g, h = objective.grad_hess(self.gather(margins), self.labels, self.weights)
        return self.own(g), self.own(h)


def agreed_num_col(dm, group, device):
    """The widest feature count over the ranks: libsvm shards may end at
    different columns, and every rank must histogram the same features."""
    widths = collectives.host_all_gather(np.asarray([dm.num_col], np.int64), group, device)
    return int(widths.max())


def combine_host_metric_entries(results, pairs, finalizers, group, device):
    """Combine every rank's metric entries -> identical lines on every rank.

    ``results``: [(name, metric, local value or None)] in one order on
    every rank; ``pairs``: a [E, 2] f64 tensor of each entry's summable
    stats; ``finalizers[j]``: fn(summed stats) -> float. The stats are
    gathered and summed over the ranks in f64 on the host."""
    gathered = collectives.all_gather(pairs.to(device), group, kind="metrics").cpu().numpy(
    ).astype(np.float64)
    summed = gathered.sum(axis=0)
    return [(name, metric, finalizers[j](summed[j]))
            for j, (name, metric, _v) in enumerate(results)]


def _is_ranking_metric(name):
    return name.split("@")[0] in ("ndcg", "map")


def _weight_sum(dm):
    w = dm.get_weight()
    return float(np.sum(w)) if w is not None else float(dm.num_row)


class MetricCombiner:
    """One round's metric entries across ranks, combined into identical
    lines on every rank (``combine_host_metric_entries``):

    * ``stats``: a metric with a device form, exactly from each rank's
      partial statistics;
    * ``mean``: a value weighted by what it averages over: a ranking
      metric (``ndcg``, ``map``, with or without ``@k``) by the rank's query
      groups, so that the line is the mean over every group of every rank,
      as xgboost's distributed ranking metrics are; a host metric or a
      feval by the rank's weight sum (the JAX package's weighted mean); a
      value computed on the global rows by 1 (identical on every rank)."""

    def __init__(self, group, device):
        self.group, self.device = group, device
        self.results, self.pairs, self.finalizers = [], [], []

    def stats(self, name, metric_name, stats, finalize):
        self.results.append((name, metric_name, None))
        self.pairs.append(stats.double().cpu())
        self.finalizers.append(lambda st: float(finalize(torch.as_tensor(st,
                                                                          dtype=torch.float64))))

    def mean(self, name, metric_name, value, weight):
        self.results.append((name, metric_name, value))
        self.pairs.append(torch.tensor([value * weight, weight], dtype=torch.float64))
        self.finalizers.append(lambda st: float(st[0] / max(st[1], 1e-12)))

    def host_metric(self, name, dm, metric_name, value):
        """A metric evaluated on the host over this rank's rows of ``dm``."""
        if _is_ranking_metric(metric_name):
            weight = float(len(dm.groups)) if dm.groups is not None else 1.0
        else:
            weight = _weight_sum(dm)
        self.mean(name, metric_name, value, weight)

    def lines(self):
        if not self.results:
            return []
        return combine_host_metric_entries(self.results, torch.stack(self.pairs),
                                           self.finalizers, self.group, self.device)


def print_metric_line(rnd, results):
    """Print round ``rnd``'s (data, metric, value) results as xgboost's
    ``[rnd]<TAB>data-metric:value...`` line (nothing without results)."""
    if results:
        print("[{}]\t{}".format(
            rnd, "\t".join("{}-{}:{:.5f}".format(d, m, v) for d, m, v in results)), flush=True)


def evaluate_host_lines(entries, metric_names, feval, objective, num_group, group=None,
                        device=None, objective_params=None, rows_cache=None):
    """Host metric lines of ``entries``, (data name, DataMatrix, numpy
    margin) each: every eval metric on the host (``eval_metrics``), then
    what ``feval(margin, dm)`` returns, the JAX package's order. The dart,
    gblinear and update loops evaluate so, as the JAX package's do.

    Across ranks (``group``), identical lines on every rank, as the JAX
    package's multi-process branch: a metric with a device form combines
    exactly from each rank's partial statistics (f64 on the host), and
    ``cox-nloglik`` is evaluated on the global rows (labels and weights
    gathered once an entry into ``rows_cache``, the margins each round);
    the rest combine as ``MetricCombiner`` weights them."""
    comb = MetricCombiner(group, device) if group is not None else None
    results = []
    for i, (name, dm, margin) in enumerate(entries):
        preds = prob_matrix = None
        for metric in metric_names:
            dmf = None
            if comb is not None:
                dmf = make_device_metric(metric, objective.name, num_group,
                                         objective_params or {})
            if dmf is not None and dmf.needs_global_rows:
                if i not in rows_cache:
                    rows_cache[i] = GlobalRows(np.asarray(dm.labels, np.float32),
                                               np.asarray(dm.get_weight(), np.float32),
                                               group, device)
                rows = rows_cache[i]
                m_g = rows.gather(np.asarray(margin, np.float32)).cpu().numpy().astype(
                    np.float64)
                value = eval_metrics.evaluate(
                    metric, objective.margin_to_prediction(m_g),
                    rows.labels.cpu().numpy().astype(np.float64),
                    rows.weights.cpu().numpy().astype(np.float64))
                comb.mean(name, metric, value, 1.0)
                continue
            if dmf is not None:
                f64 = [torch.as_tensor(np.asarray(a), dtype=torch.float64)
                       for a in (margin, dm.labels, dm.get_weight())]
                comb.stats(name, metric, dmf.partial(*f64), dmf.finalize)
                continue
            if preds is None:
                preds = objective.margin_to_prediction(margin)
                if num_group > 1:
                    prob_matrix = SoftprobMulti.margin_to_prediction(objective, margin)
            value = eval_metrics.evaluate(metric, preds, dm.labels, dm.weights,
                                          groups=dm.groups, prob_matrix=prob_matrix)
            if comb is not None:
                comb.host_metric(name, dm, metric, value)
            else:
                results.append((name, metric, value))
        if feval is not None:
            for metric_name, value in feval(margin, dm):
                if comb is not None:
                    comb.mean(name, metric_name, value, _weight_sum(dm))
                else:
                    results.append((name, metric_name, value))
    return comb.lines() if comb is not None else results


def _eval_metric_names(config, objective):
    metrics = config.eval_metric
    if metrics is None:
        metrics = [objective.default_metric]
    elif isinstance(metrics, str):
        metrics = [metrics]
    return list(metrics)


_approx_k_forcing_warned = False


def _warn_approx_k_forcing_once(requested):
    """Warn, once a process, that approx's re-sketch forces K -> 1, with the
    JAX package's words: the cuts are re-selected before every round, which
    a K-round dispatch would do once every K rounds. Every CV fold and
    elastic generation builds a session anew, hence once a process."""
    global _approx_k_forcing_warned
    if _approx_k_forcing_warned:
        return
    _approx_k_forcing_warned = True
    logger.warning(
        "tree_method='approx' re-sketches candidates before every "
        "boosting iteration; forcing _rounds_per_dispatch=%d -> 1 "
        "(set GRAFT_APPROX_RESKETCH=0 to keep batched dispatches "
        "with a single global sketch).",
        requested,
    )


def _clear_comm_round_fields():
    """Drop the collective keys from the per-round record (the JAX
    package's ``_set_comm_round_fields``): a one-rank session that follows
    a multi-rank one in the same process must not report its collectives."""
    from ..telemetry import set_round_fields

    set_round_fields(hist_comm=None, hist_comm_bytes=None, hist_comm_ms=None,
                     hist_comm_kinds=None)


class _TrainingSession:
    """Device state for one training run: bins, margins, eval sets."""

    def __init__(self, config, dtrain, evals, forest, metric_names, device, sampler=None,
                 group=None, has_feval=False, grid=None):
        self.config = config
        self.device = device
        self.group = group   # None on one rank (a grid's data group, None on one data shard)
        self.rank = collectives.world(group)[0]
        # the feature axis: a grid of more than one feature shard
        self.feature_group = grid.feature_group if grid is not None and grid.n_feature > 1 \
            else None
        self.n_feature_shards = grid.n_feature if self.feature_group is not None else 1
        self.feature_rank = grid.feature_rank if self.feature_group is not None else 0
        # collectives run across ranks on either axis
        self.across_ranks = self.group is not None or self.feature_group is not None
        # the collective's lowering, resolved once (GRAFT_HIST_COMM)
        self.hist_comm = hist_comm_impl() if self.group is not None else "psum"
        # no session inherits an earlier one's collectives: only a session
        # that runs them publishes them (note_collectives)
        _clear_comm_round_fields()
        self.objective = forest.objective()
        self.num_group = self.objective.num_output_group
        self.objective.validate_labels(dtrain.labels)

        pre_binned = isinstance(dtrain, BinnedMatrix)
        shared_cuts = None
        if self.group is not None and not pre_binned:
            # every rank must bin with identical thresholds, or the reduced
            # histograms mean nothing (a pre-binned matrix's ingest agreed
            # its cuts across the ranks already). Local ranks bin with their
            # host's cuts, as the JAX one-host mesh bins all its rows
            if local.topology() is not None and grid is None:
                shared_cuts = local.host_cuts(dtrain, config.max_bin, self.group, device)
            elif config.max_bin is None:
                # exact on a grid of one host (train refuses it over hosts)
                shared_cuts = merged_exact_cuts(dtrain, self.group, device)
            else:
                shared_cuts = merged_distributed_cuts(dtrain, config.max_bin, self.group,
                                                      device)
        if pre_binned:
            # a silently reinterpreted bin width would corrupt every
            # histogram: the config must resolve the ingest's max_bin
            if config.max_bin is None or int(config.max_bin) != dtrain.max_bin:
                raise exc.UserError(
                    "Pre-binned training data was ingested with max_bin={} but the "
                    "training config resolves max_bin={}; re-ingest or align the "
                    "hyperparameters.".format(dtrain.max_bin, config.max_bin))
            self.train_binned = dtrain
        else:
            self.train_binned = bin_matrix(dtrain, config.max_bin, cut_points=shared_cuts,
                                           exact_cap=config.exact_bin_cap, device=device)
        self.cuts = self.train_binned.cut_points
        self.num_bins = self.train_binned.num_bins
        self.num_col = self.train_binned.num_col    # the real global width
        # the feature shard's columns of the padded global width
        self.d_local = padded_feature_width(self.num_col, self.n_feature_shards) // (
            self.n_feature_shards)
        full_bins = torch.as_tensor(self.train_binned.bins, device=device)
        self._stage_bins(full_bins, torch.as_tensor(
            np.asarray([len(c) for c in self.cuts], np.int32), device=device))
        self.monotone, self.interaction_sets = constraint_tensors(config, self.num_col, device)
        if self.feature_group is not None:
            # monotone per local column; the interaction sets span the padded
            # global columns (the builders slice each node's mask)
            if self.monotone is not None:
                self.monotone = self.local_columns(self.monotone)
            if self.interaction_sets is not None:
                self.interaction_sets = shard_feature_slice(
                    self.interaction_sets, 0, self.d_local * self.n_feature_shards, 1)
        # tree_method=approx: the cuts re-sketched from the hessians before
        # every round (_resketch_bins); GRAFT_APPROX_RESKETCH=0 keeps the
        # initial sketch
        self.approx_resketch = (config.tree_method == "approx"
                                and os.environ.get("GRAFT_APPROX_RESKETCH", "1") != "0")
        if self.approx_resketch and pre_binned:
            # the re-sketch needs the float channel the ingest never held
            logger.warning("tree_method='approx' with pre-binned input keeps the ingest-time "
                           "sketch (no per-iteration re-binning).")
            self.approx_resketch = False
        self._dtrain = dtrain
        self._feats_dev = None       # train features on the device (device sketch)
        self.labels = torch.as_tensor(dtrain.labels, device=device)
        self.weights = torch.as_tensor(dtrain.get_weight(), device=device)
        # ranking: the query groups as row-index blocks, once (a matrix
        # without groups is one group of all its rows, as in xgboost)
        self.rank_blocks = None
        if self.objective.needs_groups:
            groups = [dtrain.num_row] if dtrain.groups is None else dtrain.groups
            if self.group is not None and int(np.sum(groups)) != dtrain.num_row:
                # across ranks each rank owns whole query groups: its
                # pairs never reach another rank's rows
                raise exc.UserError(
                    "rank {}'s query groups cover {} rows, but it holds {}: each host's "
                    "channel must hold whole query groups".format(
                        self.rank, int(np.sum(groups)), dtrain.num_row))
            self.rank_blocks = [torch.as_tensor(b, device=device)
                                for b in bucket_group_layout(groups)]
        # across ranks survival:cox computes its gradients on the gathered
        # global rows, and cox-nloglik its value (GlobalRows)
        self.global_rows = None
        self._eval_rows = {}    # eval set index -> GlobalRows (cox-nloglik)
        # the collectives of a dispatch's per-round metric evaluations across
        # ranks (``collectives.stats_delta``s), kept out of its rounds' own
        # (note_collectives)
        self._eval_comm = []
        if self.group is not None and self.objective.name == "survival:cox":
            self.global_rows = GlobalRows(dtrain.labels, dtrain.get_weight(), self.group,
                                          device)
        base = self.objective.base_margin(forest.base_score)
        self.margins = self._start_margins(forest, dtrain, base)
        if sampler is None and Sampler.needed(config):
            # the columns drawn over the real global width (the builders
            # slice them), the rows by data shard: a feature group's ranks
            # hold the same rows and draw the same keep masks
            sampler = Sampler(config, dtrain.num_row, self.num_col, device,
                              rank=self.rank if self.group is not None else None)
        self.sampler = sampler

        # the planes, resolved once here on the host, never on the round
        # path: SM_TRACE_DEVICE_SYNC's fence cadence, the learning stats
        # (SM_MODEL_TELEMETRY, which also captures the drift baseline from
        # the binned rows) and the device plane's round cost
        from ..telemetry import device as device_telemetry

        self._device_sync_every = env_int(DEVICE_SYNC_ENV, 0, minimum=0)
        self._dispatch_index = 0
        self.learning_stats = model_telemetry.enabled()
        self.last_learning_stats = []
        if self.learning_stats:
            model_telemetry.capture_drift_baseline(
                BinnedMatrix(full_bins, self.cuts, self.train_binned.max_bin))
        self._count_cost = device_telemetry.enabled()
        # the tracer's arming, read at each dispatch's start (_run_rounds):
        # the round's stage clock and the session's leaf spans
        self.traced = False
        self.stage_clock = None

        # each metric on the device where it has a device form, else on the
        # host (None), as the JAX package evaluates it
        self.metrics = []
        for name in metric_names:
            m = make_device_metric(name, self.objective.name, self.num_group,
                                   config.objective_params)
            if m is None and not eval_metrics.is_native_metric(name):
                raise exc.UserError(
                    "eval_metric {!r} is not supported by the PyTorch port yet".format(name)
                )
            self.metrics.append((name, m))

        # eval sets: bins and labels on the device once, margins incremental;
        # the training matrix itself shares the training margins. Entries
        # are lists: the approx re-sketch replaces their bins
        self.eval_sets = []
        self._eval_feats_dev = {}    # eval set index -> features on the device
        for dm, name in evals:
            if dm is dtrain:
                self.eval_sets.append([name, dm, None, self.labels, self.weights, None])
                continue
            if isinstance(dm, BinnedMatrix):
                # its bin indices mean thresholds only with the training cuts
                if dm.max_bin != self.train_binned.max_bin or not (
                        dm.cut_points is self.cuts
                        or (len(dm.cut_points) == len(self.cuts)
                            and all(np.array_equal(a, b)
                                    for a, b in zip(dm.cut_points, self.cuts)))):
                    raise exc.AlgorithmError(
                        "pre-binned eval set {!r} was binned with different cut points than "
                        "the training data".format(name))
                binned = dm
            else:
                binned = bin_matrix(dm, self.train_binned.max_bin, cut_points=self.cuts,
                                    device=device)
            self.eval_sets.append([
                name,
                dm,
                torch.as_tensor(binned.bins, device=device),
                torch.as_tensor(dm.labels, device=device),
                torch.as_tensor(dm.get_weight(), device=device),
                self._start_margins(forest, dm, base),
            ])
        self._plan_dispatch(config, has_feval)

    def _plan_dispatch(self, config, has_feval):
        """K rounds a dispatch, as the JAX package's session plans them:
        approx's re-sketch forces K = 1 (with its warning, once a process);
        under K > 1 the per-round metric values ride the dispatch's one
        copy when every metric has a device form and there is no feval and
        no ranking objective (``device_batched_metrics``), else the host
        evaluates once a dispatch, at its last round (``host_eval_batched``).
        Then the static capture decision, logged once with its reason."""
        from ..telemetry import REGISTRY

        K = max(1, config.rounds_per_dispatch)
        if self.approx_resketch and K > 1:
            _warn_approx_k_forcing_once(K)
            K = 1
        self.rounds_per_dispatch = K
        self.device_batched_metrics = bool(
            K > 1 and self.eval_sets and self.metrics and not has_feval
            and not self.objective.needs_groups
            and all(m is not None for _name, m in self.metrics))
        self.host_eval_batched = K > 1 and bool(self.eval_sets) and not (
            self.device_batched_metrics)
        if self.host_eval_batched:
            logger.info(
                "_rounds_per_dispatch=%d with eval metrics that cannot ride back from the "
                "device: keeping the fused dispatch; host metrics are computed once per "
                "dispatch (every %d rounds).", K, K)
        REGISTRY.gauge(
            "dispatch_fused_rounds",
            "Boosting rounds fused into one device dispatch per round "
            "program (the lax.scan length K of the fused round pipeline)",
        ).set(K)
        self.captured, self.capture_reason = capture_decision(
            self.device, K, self.group if self.group is not None else self.feature_group,
            config, self.approx_resketch)
        self.graph = RoundGraph(self._round_body) if self.captured else None
        self._slots = None   # the captured session's static [K, ...] outputs
        logger.info("round dispatch: %d round(s) a dispatch, %s (%s)", K,
                    "captured" if self.captured else "eager", self.capture_reason)

    def local_columns(self, t, fill=0):
        """A per-feature tensor of the real global width -> this feature
        shard's columns (itself without a feature axis)."""
        if self.feature_group is None:
            return t
        return shard_feature_slice(t, self.feature_rank, self.d_local, self.n_feature_shards,
                                   fill)

    def _stage_bins(self, bins, num_cuts):
        """The training rows' bins [n, d] and cut counts [d] (every column,
        on the device) -> the session's: this feature shard's columns, the
        padded ones always missing with no cut."""
        self.bins = self.local_columns(bins, fill=self.num_bins - 1)
        self.num_cuts = self.local_columns(num_cuts.int())

    def builder_axes(self):
        """The builders' arguments of the ranks' axes: the data group and
        its lowering, and the feature axis."""
        return dict(group=self.group, hist_comm=self.hist_comm,
                    feature_group=self.feature_group,
                    n_feature_shards=self.n_feature_shards, d_global=self.num_col)

    def release_graph(self):
        """Free the captured round and its memory pool (the session's end)."""
        if self.graph is not None:
            self.graph.release()

    def _start_margins(self, forest, dm, base):
        """Margins of ``dm``'s rows before the first new round ([n], or
        [n, C] for a multi-output objective): the base margin plus the
        resumed forest's trees, each round's trees summed into their class's
        column and the sum added, as the rounds added them, so that a
        resumed run's margins equal an uninterrupted run's bit for bit."""
        shape = (dm.num_row,) if self.num_group == 1 else (dm.num_row, self.num_group)
        margins = torch.full(shape, base, dtype=torch.float32, device=self.device)
        if not forest.trees:
            return margins
        indptr = forest.iteration_indptr
        rounds = len(indptr) - 1
        for lo_row, x in _feature_row_blocks(dm, self.device):
            m = margins[lo_row:lo_row + x.shape[0]]
            r = 0
            while r < rounds:
                # the trees of whole rounds, up to _RESUME_TREES_PER_PASS a pass
                r_hi = r + 1
                while r_hi < rounds and indptr[r_hi + 1] - indptr[r] <= _RESUME_TREES_PER_PASS:
                    r_hi += 1
                lo, hi = indptr[r], indptr[r_hi]
                _, stacked = forest._stack(lo, hi)
                leaves = forest_leaf_values(stacked, x)
                for rr in range(r, r_hi):
                    total = torch.zeros_like(m)
                    for t in range(indptr[rr], indptr[rr + 1]):
                        if self.num_group == 1:
                            total += leaves[:, t - lo]
                        else:
                            total[:, forest.tree_info[t]] += leaves[:, t - lo]
                    m += total
                r = r_hi
        return margins

    def _resketch_bins(self):
        """tree_method=approx: re-select the cuts from the current hessians
        (xgboost re-sketches its candidates every iteration) and re-bin the
        training rows and every eval set, as the JAX package's
        ``_resketch_bins`` does before each dispatch, round 0 and a resumed
        run's first round included. The hessians are the objective's
        pointwise ones, summed over the classes of a multiclass objective.

        Under the device lowering (``GRAFT_SKETCH_IMPL``; ``auto`` on a CUDA
        session) the hessians stay on the device, the float features of the
        training rows and of each eval set are staged there once, and only
        the [d, max_bin - 1] cuts come back to the host (for compacting the
        round's trees). Trees already committed keep the cuts they were
        built with: each round's trees are compacted to float thresholds
        before the next re-sketch."""
        _g, h = self.pointwise_grad_hess(self.margins)
        if h.dim() == 2:
            h = h.sum(dim=1)
        max_bin = self.train_binned.max_bin
        if _sketch_impl(self.device) == "device":
            if self._feats_dev is None:
                self._feats_dev = torch.as_tensor(self._dtrain.features, dtype=torch.float32,
                                                  device=self.device)
            mids, n_cuts = device_cut_points(self._feats_dev, h, max_bin - 1)
            if self.group is not None:
                mids, n_cuts = self._merge_device_cuts(mids, n_cuts, max_bin - 1)
            self._stage_bins(device_apply(self._feats_dev, mids, n_cuts, max_bin), n_cuts)
            for i, entry in enumerate(self.eval_sets):
                if entry[2] is None:
                    continue
                if i not in self._eval_feats_dev:
                    self._eval_feats_dev[i] = torch.as_tensor(
                        entry[1].features, dtype=torch.float32, device=self.device)
                entry[2] = device_apply(self._eval_feats_dev[i], mids, n_cuts, max_bin)
            self.cuts = cut_lists(mids, n_cuts)
            return
        feats = self._dtrain.features
        if self.group is not None:
            cuts = merged_distributed_cuts(self._dtrain, max_bin, self.group, self.device,
                                           weights=h.cpu().numpy())
        else:
            cuts = compute_cut_points(feats, h.cpu().numpy(), max_bin)
        self._stage_bins(
            torch.as_tensor(apply_cut_points(feats, cuts, max_bin), device=self.device),
            torch.as_tensor(np.asarray([len(c) for c in cuts], np.int32), device=self.device))
        for entry in self.eval_sets:
            if entry[2] is not None:
                entry[2] = torch.as_tensor(
                    apply_cut_points(entry[1].features, cuts, max_bin), device=self.device)
        self.cuts = cuts

    def _merge_device_cuts(self, mids, n_cuts, width):
        """Across ranks under the device lowering: this rank's candidates
        (``device_cut_points``' padded mids) gathered and merged as
        ``merged_distributed_cuts`` merges them -> the merged cuts, padded,
        on the device."""
        pad = torch.arange(width, device=mids.device)[None, :] >= n_cuts[:, None]
        mat = torch.where(pad, torch.full((), float("nan"), device=mids.device), mids)
        return pad_cut_points(gather_merged_cuts(mat, n_cuts, self.group, width, "cuts"),
                              self.device)

    def pointwise_grad_hess(self, margins):
        """The objective's own (g, h) at ``margins``; survival:cox across
        ranks on the global rows."""
        if self.global_rows is not None:
            return self.global_rows.grad_hess(self.objective, margins)
        return self.objective.grad_hess(margins, self.labels, self.weights)

    def grad_hess(self, margins):
        """The objective's (g, h) at ``margins`` ([n] or [n, C]), over the
        query groups for a ranking objective."""
        if self.rank_blocks is not None:
            return lambdarank_grad_hess(margins, self.labels, self.weights,
                                        self.rank_blocks, scheme=self.objective.scheme)
        return self.pointwise_grad_hess(margins)

    def run_round(self, rnd):
        """Round ``rnd`` alone, a dispatch of one round -> its host tree
        dicts, one per parallel tree."""
        return self.run_rounds(rnd, 1).trees[0]

    def run_rounds(self, rnd, rounds_left):
        """One dispatch of min(K, ``rounds_left``) rounds from ``rnd`` ->
        ``Dispatch``: ``trees``, per round the list of its host tree dicts
        (arrays [max_nodes], or [C, max_nodes] for C classes), one per
        parallel tree; ``metrics``, the per-round device metric values [k,
        n_sets, n_metrics] (f64 numpy) under ``device_batched_metrics``,
        else None. With the learning stats armed, ``last_learning_stats``
        holds each round's decoded vector.

        A CUDA out-of-memory error anywhere in the dispatch is terminal (no
        retry fits a full card): it goes through the OOM forensics dump and
        the watchdog's abort (exit 86). Every other exception propagates
        unchanged."""
        try:
            return self._run_rounds(rnd, min(self.rounds_per_dispatch, rounds_left))
        except Exception as e:
            from ..telemetry import device as device_telemetry

            if device_telemetry.is_oom_error(e):
                self._abort_device_oom(e)
            raise

    def _abort_device_oom(self, exc):
        """Dump the OOM forensics (largest allocated blocks, allocator
        stats, round cost, last watermark), then take the watchdog's abort
        path (checkpoint flush, flight recorder, ``training.abort``) with
        exit 86."""
        from ..constants import EXIT_DEVICE_OOM
        from ..telemetry import device as device_telemetry
        from ..training import watchdog

        path = device_telemetry.dump_oom_forensics(exc)
        watchdog.request_abort("device_oom", EXIT_DEVICE_OOM, error=str(exc)[:400],
                               forensics=path or "")

    def phase(self, name):
        """The session leaf ``name`` while this dispatch is traced, else a
        no-op context: a tracer span and, under a profiler, its range
        (``tracing.trace_span``), never a ``span()`` phase, so the round's
        ``PhaseRecorder`` and the registry count none of it twice."""
        return tracing.trace_span(name) if self.traced else _UNTRACED

    def _run_rounds(self, rnd, k):
        """The dispatch, fenced on every N-th one (``SM_TRACE_DEVICE_SYNC``):
        the host's enqueue timed as the ``host_dispatch`` phase and the wait
        for the card as ``device_sync``, both into the active
        ``PhaseRecorder``; then the dispatch's one device-to-host copy.

        While the tracer records at its start (``tracing.recording()``) the
        dispatch is traced: its rounds carry the stage clock
        (``ops/stamps``), whose times become the tracer's ``round.<stage>``
        spans, and the enqueue and the copy are the session's leaves
        ``session.enqueue`` and ``session.copy_out``."""
        sampled = (self._device_sync_every > 0
                   and self._dispatch_index % self._device_sync_every == 0)
        self._dispatch_index += 1
        self.traced = tracing.recording()
        clock = None
        if self.traced:
            if self.stage_clock is None:
                self.stage_clock = StageClock(self.device, self.rounds_per_dispatch)
            clock = self.stage_clock
            clock.measure_offset()
        probe = self._cost_probe() if self._count_cost else None
        if not sampled:
            with self.phase("session.enqueue"):
                outs, values = self._enqueue_rounds(rnd, k, clock)
        else:
            from ..telemetry import compile_stats

            pre_build = compile_stats()["seconds"]
            with span("host_dispatch"), self.phase("session.enqueue"):
                outs, values = self._enqueue_rounds(rnd, k, clock)
            # a kernel build inside this dispatch is RoundTimer's `compile`
            # key: take exactly that overlap out of host_dispatch
            overlap = compile_stats()["seconds"] - pre_build
            recorder = active_recorder()
            if overlap > 0 and recorder is not None:
                recorder.add("host_dispatch", -overlap)
            with span("device_sync"):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        with self.phase("session.copy_out"):
            out = self._to_host(outs, values, k, clock)
        if out.stages is not None:
            self._stage_spans(rnd, out.stages)
        if probe is not None:
            self._note_cost(probe, k)
        return out

    def _stage_spans(self, rnd, stages):
        """Each round's stages as the tracer's ``round.<stage>`` spans on the
        device lane, mapped onto the tracer's clock by the session's offset:
        laid end to end from the round's first stamp (``gradient`` is where
        it ran; a later stage, the sum of its intervals)."""
        offset = self.stage_clock.offset_ns
        trace_id = tracing.new_id()
        for j, row in enumerate(stages):
            t = int(row[FIRST]) + offset
            for s, name in enumerate(STAGES):
                ns = int(row[s])
                tracing.record_span_at("round." + name, t, ns, trace_id=trace_id,
                                       attributes={"round": rnd + j, "clock": "device"})
                t += ns

    def note_stage_phases(self, batch, j):
        """Round ``j`` of a traced dispatch: its stages' seconds into the
        active ``PhaseRecorder`` as ``device.<stage>``."""
        recorder = None if batch.stages is None else active_recorder()
        if recorder is None:
            return
        for s, name in enumerate(STAGES):
            recorder.add("device." + name, float(batch.stages[j, s]) / 1e9)

    def _enqueue_rounds(self, rnd, k, clock=None):
        """Enqueue rounds ``rnd`` .. ``rnd + k - 1`` -> (the round body's
        outputs stacked [k, ...] on the device, metrics and learning stats
        None where not computed; across ranks under
        ``device_batched_metrics``, each round's metric values [k, n_sets,
        n_metrics] from ``_evaluate_across_ranks`` after its round, else
        None). A captured session runs its first round eagerly (a real
        round, the warm-up), captures the body before its second, and
        replays the graph for every later one, each replay's outputs copied
        into slot j of the static [K, ...] buffers. ``clock``: the dispatch's
        ``StageClock``, or None; a graph captured with the other arming is
        released and captured again before its next replay."""
        per_round, values = [], None
        if self.group is not None and self.device_batched_metrics:
            values = np.zeros((k, len(self.eval_sets), len(self.metrics)), np.float64)
        for j in range(k):
            if self.approx_resketch:
                self._resketch_bins()
            if j == 0 and fault_point("train.gradient_poison",
                                      dispatch=self._dispatch_index - 1):
                # numeric-poison drill: NaN margins, so that the round's
                # gradients go NaN through the real pipeline and the guard
                # must catch them there (in place: a graph reads this tensor)
                self.margins.mul_(float("nan"))
            draws = self.sampler.draw(rnd + j) if self.sampler is not None else None
            if self.graph is None:
                per_round.append(self._round_body(draws, clock))
                if values is not None:
                    # the rounds run eagerly across ranks and wait on their
                    # collectives anyway: K=1's evaluation, a round at a
                    # time (its collectives are not the round's own)
                    before = collectives.stats_snapshot()
                    lines = self._evaluate_across_ranks(None)
                    self._eval_comm.append(collectives.stats_delta(before))
                    values[j] = np.asarray([v for _d, _m, v in lines]).reshape(values.shape[1:])
                continue
            if self._slots is None:
                out = self._round_body(draws, clock)
                self._slots = [None if t is None else
                               torch.empty((self.rounds_per_dispatch,) + tuple(t.shape),
                                           dtype=t.dtype, device=t.device) for t in out]
            else:
                if self.graph.armed and self.graph.stamped != (clock is not None):
                    self.graph.release()
                if not self.graph.armed:
                    self.graph.capture(draws, clock)
                out = self.graph.replay(draws)
            for slot, t in zip(self._slots, out):
                if slot is not None:
                    slot[j].copy_(t)
        if self.graph is not None:
            return [None if s is None else s[:k] for s in self._slots], values
        return [None if first is None else torch.stack([o[i] for o in per_round])
                for i, first in enumerate(per_round[0])], values

    def _to_host(self, outs, values, k, clock=None):
        """The dispatch's one device-to-host copy: the packed trees, the
        metric values, the learning stats and ``clock``'s rows (a traced
        dispatch's ``StageClock``, else None) in one flat f64 tensor (the
        trees alone in f32; the rows' stage nanoseconds exact, their first
        and last stamps to 256 ns). ``values``: the metric values already on
        the host (across ranks), else None."""
        packed, metrics, stats = outs
        stamps = None if clock is None else clock.read(k)
        parts = [packed] + [t for t in (metrics, stats, stamps) if t is not None]
        if len(parts) == 1:
            flat = packed.cpu().numpy().reshape(-1)
        else:
            flat = torch.cat([p.reshape(-1).double() for p in parts]).cpu().numpy()
        n = packed.numel()
        host = flat[:n].reshape(tuple(packed.shape))
        if metrics is not None:
            m = metrics.numel()
            values = flat[n:n + m].reshape(tuple(metrics.shape))
            n += m
        rows = []
        if stats is not None:
            rows = flat[n:n + stats.numel()].reshape(k, -1)
            n += stats.numel()
        self.last_learning_stats = [model_telemetry.decode_device_stats(row) for row in rows]
        stages = None if stamps is None else flat[n:].reshape(k, -1).astype(np.int64)
        return Dispatch([[unpack_tree(p) for p in host[j]] for j in range(k)], values, stages)

    def _cost_probe(self):
        """Before the session's first dispatch: the kernel-work tally and the
        device memory, for the device plane's round cost."""
        from ..ops import histogram

        resident = 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            resident = torch.cuda.memory_allocated(self.device)
        return dict(histogram.WORK), resident

    def _note_cost(self, probe, k):
        """After the first dispatch (its copy to the host has synchronized):
        one ``training.compiled`` record of its ``k`` rounds' counted cost,
        with the dispatch's graph state (``captured`` or ``eager``) and its
        reason. Runs once a session; best-effort."""
        from ..ops import histogram
        from ..telemetry import device as device_telemetry

        self._count_cost = False
        try:
            work, resident = probe
            peak = (torch.cuda.max_memory_allocated(self.device)
                    if self.device.type == "cuda" else 0)
            cost = device_telemetry.cost_from_launches(
                histogram.WORK["bytes"] - work["bytes"],
                histogram.WORK["adds"] - work["adds"], resident, peak)
            cost["dispatch_graph"] = "captured" if self.captured else "eager"
            cost["dispatch_graph_reason"] = self.capture_reason
            device_telemetry.note_compiled(cost, rounds_per_dispatch=k,
                                           backend=self.device.type)
        except Exception as e:
            logger.warning("round cost count failed (%s); training continues without the "
                           "training.compiled record", e)

    def _round_body(self, draws, clock=None):
        """One round on the device, the region a capture records: the
        gradients, the round's ``num_parallel_tree`` trees (C per tree for C
        classes), the training and eval margins, the per-round metrics and
        the packing -> (packed trees [P, 10, ...], the metrics or None,
        the learning stats [8] or None). It updates the session's tensors
        in place and, on one rank, makes no host sync. ``clock``: a
        ``StageClock`` stamping the round's stages into its row
        (``ops/stamps``), or None; decided by the dispatch."""
        cfg = self.config
        if clock is not None:
            clock.begin()
        g, h = self.grad_hess(self.margins)
        g_stat, h_stat = g, h
        if self.num_group > 1:
            # [n, C] -> the builder's contiguous [C, n]
            g, h = g.T.contiguous(), h.T.contiguous()
        if clock is not None:
            clock(GRADIENT)
        common = dict(
            num_bins=self.num_bins, max_depth=cfg.max_depth,
            reg_lambda=cfg.reg_lambda, alpha=cfg.alpha, gamma=cfg.gamma,
            min_child_weight=cfg.min_child_weight,
            # the round's trees fit the same gradients: their sum is averaged
            eta=cfg.eta / cfg.num_parallel_tree,
            max_delta_step=cfg.max_delta_step,
            monotone=self.monotone, interaction_sets=self.interaction_sets,
            stamp=clock, **self.builder_axes(),
        )
        trees, total = [], None
        for k in range(cfg.num_parallel_tree):
            gk, hk, masks = g, h, None
            if draws is not None:
                keep, masks = draws[k]
                if keep is not None:
                    # dropped rows stay routed, with zero gradients
                    gk, hk = g * keep, h * keep
            if cfg.grow_policy == "lossguide":
                tree, row_out = build_tree_lossguide(
                    self.bins, gk, hk, self.num_cuts, max_leaves=cfg.max_leaves,
                    masks=masks, **common)
            else:
                tree, row_out = build_tree(self.bins, gk, hk, self.num_cuts, masks=masks,
                                           **common)
            trees.append(tree)
            total = row_out if total is None else total + row_out
        self.margins += total if self.num_group == 1 else total.T
        for _name, _dm, bins, _labels, _weights, margins in self.eval_sets:
            if bins is not None:
                out = None
                for tree in trees:
                    o = predict_binned(tree, bins, cfg.predict_depth, self.num_bins)
                    out = o if out is None else out + o
                margins += out if self.num_group == 1 else out.T
        packed = [pack_tree(tree) for tree in trees]
        stacked = packed[0][None] if len(packed) == 1 else torch.stack(packed)
        metrics = (self._round_metrics()
                   if self.device_batched_metrics and self.group is None else None)
        vec = None
        if self.learning_stats:
            vec = learning_stats(g_stat, h_stat, self.margins)
            if self.group is not None:
                # sums and counts summed, extrema min / max over the ranks, as
                # the JAX round's psum / pmin / pmax: one gather
                every = collectives.all_gather(vec, self.group, kind="stats")
                sums, mins, maxs = every.sum(0), every.min(0).values, every.max(0).values
                vec = torch.stack([sums[0], mins[1], maxs[2], sums[3], mins[4], maxs[5],
                                   sums[6], sums[7]])
        if clock is not None:
            clock.end()
        return stacked, metrics, vec

    def _round_metrics(self):
        """The round's device metrics on one rank, kept on the device as the
        JAX scan stacks its ``metrics_all``: f64 [n_sets, n_metrics] (each
        metric's own dtype, widened)."""
        rows = []
        for _name, _dm, _bins, labels, weights, margins in self.eval_sets:
            m = self.margins if margins is None else margins
            rows.append(torch.stack([metric(m, labels, weights).double()
                                     for _n, metric in self.metrics]))
        return torch.stack(rows)

    def evaluate(self, feval=None):
        """-> list of (data_name, metric_name, value) per eval set: the eval
        metrics, then what ``feval(margin, dm)`` returns for the set's host
        margins ([n] or [n, C]), the JAX package's order."""
        if self.group is not None:
            return self._evaluate_across_ranks(feval)
        results = []
        for name, dm, _bins, labels, weights, margins in self.eval_sets:
            m = self.margins if margins is None else margins
            host = None
            for metric_name, metric in self.metrics:
                if metric is not None:
                    value = float(metric(m, labels, weights))
                else:
                    if host is None:
                        host = self._host_predictions(m)
                    preds, prob_matrix = host
                    value = eval_metrics.evaluate(
                        metric_name, preds, dm.labels, dm.weights, groups=dm.groups,
                        prob_matrix=prob_matrix)
                results.append((name, metric_name, value))
            if feval is not None:
                for metric_name, value in feval(m.cpu().numpy(), dm):
                    results.append((name, metric_name, value))
        return results

    def _evaluate_across_ranks(self, feval):
        """``evaluate`` over every rank's rows, identical on every rank: a
        metric with a device form combines exactly from each rank's partial
        statistics, ``cox-nloglik`` is computed on the gathered global
        rows, and a host metric and a feval combine as ``MetricCombiner``
        weights them (a weight-sum weighted mean as in the JAX package,
        whose distributed xgboost averages python-side metrics so; the
        ranking metrics over the query groups)."""
        comb = MetricCombiner(self.group, self.device)
        for i, (name, dm, _bins, labels, weights, margins) in enumerate(self.eval_sets):
            m = self.margins if margins is None else margins
            host = None
            for metric_name, metric in self.metrics:
                if metric is not None and metric.needs_global_rows:
                    rows = self._rows_of(i, labels, weights)
                    comb.mean(name, metric_name,
                              float(metric(rows.gather(m), rows.labels, rows.weights)), 1.0)
                    continue
                if metric is not None:
                    comb.stats(name, metric_name, metric.partial(m, labels, weights),
                               metric.finalize)
                    continue
                if host is None:
                    host = self._host_predictions(m)
                preds, prob_matrix = host
                value = eval_metrics.evaluate(
                    metric_name, preds, dm.labels, dm.weights, groups=dm.groups,
                    prob_matrix=prob_matrix)
                comb.host_metric(name, dm, metric_name, value)
            if feval is not None:
                for metric_name, value in feval(m.cpu().numpy(), dm):
                    comb.mean(name, metric_name, value, _weight_sum(dm))
        return comb.lines()

    def _rows_of(self, i, labels, weights):
        """The global rows of eval set ``i`` (the training rows' own where
        they are the training matrix), gathered at first use."""
        if self.eval_sets[i][5] is None and self.global_rows is not None:
            return self.global_rows
        if i not in self._eval_rows:
            self._eval_rows[i] = GlobalRows(labels, weights, self.group, self.device)
        return self._eval_rows[i]

    def note_collectives(self, before, k):
        """After a dispatch of ``k`` rounds across ranks: its rounds'
        collectives' host seconds, calls and payload bytes
        (``collectives.STATS`` against the snapshot ``before``, less the
        per-round metric evaluations') as the per-round ``hist_comm_ms`` /
        ``hist_comm_bytes`` round fields (the dispatch's over ``k``:
        RoundTimer's collective share a round) and, by kind,
        ``hist_comm_kinds`` ({kind: {"bytes", "ms", "calls"}} a round: the
        histograms' "hist" and "totals" apart from a grid's "merge" and
        "route"), the ``hist_comm_bytes_total`` counter, and a
        ``collective.dispatch`` span under the open round span (the fleet
        plane's collective phase), both at the dispatch's totals. Measured
        on the host clock: with gloo the wait for the peers, with NCCL the
        enqueue."""
        from ..telemetry import REGISTRY, set_round_fields, tracing

        delta = collectives.stats_delta(before)
        for ev in self._eval_comm:
            for key in ("seconds", "bytes", "calls"):
                delta[key] -= ev[key]
            for kind, part in ev["kinds"].items():
                mine = delta["kinds"].get(kind)
                if mine is not None:
                    for key in ("seconds", "bytes", "calls"):
                        mine[key] -= part[key]
        self._eval_comm = []
        seconds, nbytes, calls = delta["seconds"], delta["bytes"], delta["calls"]
        kinds = {kind: {"bytes": int(round(v["bytes"] / k)),
                        "ms": round(v["seconds"] * 1000.0 / k, 3),
                        "calls": round(v["calls"] / k, 3)}
                 for kind, v in sorted(delta["kinds"].items()) if v["calls"] > 0}
        set_round_fields(hist_comm_ms=round(seconds * 1000.0 / k, 3),
                         hist_comm_bytes=int(round(nbytes / k)), hist_comm_kinds=kinds)
        REGISTRY.counter(
            "hist_comm_bytes_total",
            "Payload bytes of the training rounds' cross-rank collectives",
            {"impl": self.hist_comm},
        ).inc(nbytes)
        if tracing.enabled():
            tracing.record_span("collective.dispatch", duration_s=seconds, attributes={
                "impl": self.hist_comm, "bytes": nbytes, "calls": calls, "measured": True})

    def _host_predictions(self, margins):
        """(predictions, class probabilities or None) on the host, for the
        metrics without a device form."""
        margin = margins.cpu().numpy()
        prob_matrix = None
        if self.num_group > 1:
            prob_matrix = SoftprobMulti.margin_to_prediction(self.objective, margin)
        return self.objective.margin_to_prediction(margin), prob_matrix


def _feature_row_blocks(dm, device):
    """(first row, f32 [rows, d] on ``device``) blocks of ``dm``'s rows for
    a traversal: a DataMatrix's floats in one block; a pre-binned matrix's
    ``rep_block`` representatives, ``_REP_BLOCK_ROWS`` at a time (the JAX
    package's ``_predict_margin_rows``), which route every row to the leaf
    its original floats reach, so the margins are bitwise those of the
    floats, without ever holding the float channel."""
    if not isinstance(dm, BinnedMatrix):
        yield 0, torch.as_tensor(dm.features, device=device)
        return
    for lo in range(0, dm.num_row, _REP_BLOCK_ROWS):
        yield lo, torch.as_tensor(dm.rep_block(lo, min(lo + _REP_BLOCK_ROWS, dm.num_row)),
                                  device=device)


def _abort_numeric_poison(round_index):
    """The numeric-health guard tripped (a NaN/Inf count of the round's
    learning stats went nonzero): dump the learning forensics, naming the
    first poisoned round, then take the watchdog's abort path with exit
    87."""
    from ..constants import EXIT_NUMERIC_POISON
    from ..training import watchdog

    path = model_telemetry.dump_learning_forensics("numeric_poison",
                                                   first_bad_round=round_index)
    watchdog.request_abort("numeric_poison", EXIT_NUMERIC_POISON, round=int(round_index),
                           forensics=path or "")


def train(
    params,
    dtrain,
    num_boost_round=10,
    evals=(),
    feval=None,
    device=None,
    callbacks=None,
    verbose_eval=True,
    xgb_model=None,
    _sampler=None,
    group=None,
    grid=None,
):
    """Train a Forest on ``device`` (CUDA unless given). API mirrors
    ``xgb.train``: ``evals`` is a list of (DataMatrix, name) pairs whose
    metric lines print each round when ``verbose_eval``; ``feval(margin,
    dm)`` returns [(name, value), ...] from an eval set's raw margins, and
    its values join the metric lines (and early stopping) after the eval
    metrics. ``xgb_model``, a Forest or a model-file path, resumes
    training: its trees stay, the margins start from its predictions, and
    round numbers continue from its last round. ``_sampler``: an object
    with ``models.sampling.Sampler``'s ``draw`` in place of the port's own
    draws (the tests replay the JAX package's).

    ``booster=gblinear`` trains a ``gblinear.LinearModel`` (resuming only
    from one), ``booster=dart`` runs ``dart.train_dart`` and
    ``process_type=update`` refreshes or prunes the trees of ``xgb_model``
    (``update.train_update``), in the JAX package's order of checks.

    ``group``: a ``torch.distributed`` process group for data-parallel
    training, or None for one rank (the JAX package's ``mesh=``). Every rank
    calls ``train`` with the same parameters and its own rows (their counts
    may differ; a ranking objective's ranks hold whole query groups); every
    rank returns the same model. Every booster, objective and tree method
    trains across ranks but ``tree_method=exact`` across hosts, which raises
    ``UserError`` before any collective (``refuse_across_ranks``); the local
    ranks of one host (``parallel/local.py``) train it, as the JAX one-host
    mesh does.

    ``grid``: a ``parallel/grid.Grid`` of data x feature shards in place of
    ``group`` (the JAX package's 2-D ``mesh=``): the ranks of one data shard
    pass the same rows, and each keeps only its feature shard's columns of
    their bins. gbtree (either growth policy, every objective, sampling and
    the constraints) and dart grow their trees over both axes; gblinear and
    ``process_type=update`` train over the data group. ``tree_method=exact``
    trains on a grid of one host and raises ``UserError`` on one over
    hosts. Every rank returns the same model."""
    dev = resolve_device(device)
    config = TrainConfig(params)
    callbacks = list(callbacks or [])
    if grid is not None:
        if group is not None:
            raise exc.UserError("train() takes a process group (group=) or a grid (grid=), "
                                "not both")
        group = grid.data_group if grid.n_data > 1 else None
    if isinstance(dtrain, BinnedMatrix) and (
            config.booster != "gbtree" or config.process_type != "default"):
        # gblinear fits the raw floats, and dart and update traverse them:
        # representative values would silently change the model
        raise exc.UserError(
            "Pre-binned training input (chunked ingest) requires booster='gbtree' with "
            "process_type='default'; got booster={!r} process_type={!r}. Use "
            "SM_INGEST_MODE=whole.".format(config.booster, config.process_type))
    across = grid.world if grid is not None and grid.n_data * grid.n_feature > 1 else group
    if collectives.world(across)[1] > 1:
        hosts = grid.n_hosts if grid is not None else local.num_hosts_of(group)
        if hosts > 1:
            refuse_across_ranks(config)
        if not isinstance(dtrain, BinnedMatrix):
            # a pre-binned matrix's ingest agreed the width across ranks
            d = agreed_num_col(dtrain, across, dev)
            padded = dtrain.pad_features(d)
            if padded is not dtrain:
                padded.host_rows = getattr(dtrain, "host_rows", None)
            evals = [(padded if dm is dtrain else dm.pad_features(d), name)
                     for dm, name in evals]
            dtrain = padded
    else:
        group = None
    if config.process_type == "update" and config.booster == "gblinear":
        # checked before the gblinear branch, which would otherwise boost
        # more rounds where a refresh was asked for
        raise exc.UserError(
            "process_type 'update' can only be used with updater 'refresh' and "
            "'prune' (tree boosters); booster=gblinear does not support it."
        )
    if config.booster == "gblinear":
        from .compat import load_model_any_format
        from .gblinear import LinearModel, train_linear

        initial = xgb_model
        if xgb_model is not None and not isinstance(xgb_model, LinearModel):
            initial, _fmt = load_model_any_format(xgb_model, device=dev)
            if not isinstance(initial, LinearModel):
                raise exc.UserError("Checkpoint {} is not a gblinear model".format(xgb_model))
        # whole columns over the data group, as the JAX package's gblinear
        # reads only the mesh's data axis
        return train_linear(config, dtrain, num_boost_round, evals=list(evals), feval=feval,
                            callbacks=callbacks, initial_model=initial, device=dev,
                            verbose_eval=verbose_eval, group=group)

    if xgb_model is None:
        objective_params = {
            k: v for k, v in config.objective_params.items() if k in OBJECTIVE_PARAM_KEYS
        }
        groups = create_objective(config.objective, objective_params).num_output_group
        forest = Forest(
            objective_name=config.objective,
            objective_params=objective_params,
            base_score=config.base_score,
            num_feature=dtrain.num_col,
            num_class=config.num_class if groups > 1 else 0,
            feature_names=dtrain.feature_names,
            device=dev,
        )
    elif isinstance(xgb_model, Forest):
        forest = xgb_model.to(dev)
    else:
        forest = Forest.load_model(xgb_model, device=dev)
    if forest.num_feature < dtrain.num_col and forest.trees:
        raise exc.UserError("feature_names mismatch between checkpoint and data")
    forest.num_feature = max(forest.num_feature, dtrain.num_col)
    if config.process_type == "update":
        from .update import train_update

        return train_update(config, forest, dtrain, list(evals), feval, callbacks,
                            num_boost_round, verbose_eval=verbose_eval, group=group)
    if config.booster == "dart":
        from .dart import train_dart

        return train_dart(config, forest, dtrain, list(evals), feval, callbacks,
                          num_boost_round, dev, verbose_eval=verbose_eval, group=group,
                          grid=grid)
    metric_names = _eval_metric_names(config, forest.objective())
    session = _TrainingSession(config, dtrain, list(evals), forest, metric_names, dev,
                               sampler=_sampler, group=group, has_feval=feval is not None,
                               grid=grid)

    for cb in callbacks:
        if hasattr(cb, "before_training"):
            forest = cb.before_training(forest) or forest

    evals_log = {}
    start_round = forest.num_boosted_rounds
    end_round = start_round + num_boost_round
    C, P = session.num_group, config.num_parallel_tree
    rnd, stop = start_round, False
    try:
        # one dispatch builds min(K, rounds left) rounds; they commit one at
        # a time, and a stop mid-dispatch discards the rest of it
        while rnd < end_round and not stop:
            comm_before = collectives.stats_snapshot()
            batch = session.run_rounds(rnd, end_round - rnd)
            if session.across_ranks:
                session.note_collectives(comm_before, len(batch.trees))
            for j, trees_np in enumerate(batch.trees):
                with session.phase("session.commit"):
                    # class-major: class 0's P trees, then class 1's, ...
                    # (xgboost's layout)
                    if C == 1:
                        trees = [compact_padded_tree(t, session.cuts) for t in trees_np]
                    else:
                        trees = [compact_padded_tree({k: v[c] for k, v in t.items()},
                                                     session.cuts)
                                 for c in range(C) for t in trees_np]
                    forest.append_round(trees, [c for c in range(C) for _ in range(P)])
                    if j < len(session.last_learning_stats):
                        # the model-quality plane: the round's reductions and
                        # the committed trees' stats -> one training.learning
                        # record, then the numeric-health guard (NaN/Inf ->
                        # forensics + exit 87)
                        stats = dict(session.last_learning_stats[j])
                        stats.update(model_telemetry.tree_stats(trees))
                        model_telemetry.note_learning(rnd, stats)
                        if model_telemetry.first_poisoned_round([stats], rnd) is not None:
                            _abort_numeric_poison(rnd)
                session.note_stage_phases(batch, j)
                if batch.metrics is not None:
                    results = [(name, metric_name, float(batch.metrics[j, si, i]))
                               for si, (name, *_rest) in enumerate(session.eval_sets)
                               for i, (metric_name, _m) in enumerate(session.metrics)]
                elif not session.host_eval_batched or j == len(batch.trees) - 1:
                    # the host cadence under K > 1: once a dispatch, at its
                    # last round, whose margins are the committed forest's (a
                    # dispatch builds no round past the last one asked for)
                    with session.phase("session.eval"):
                        results = session.evaluate(feval)
                else:
                    results = []
                for data_name, metric_name, value in results:
                    evals_log.setdefault(data_name, {}).setdefault(metric_name, []).append(
                        value)
                if verbose_eval:
                    print_metric_line(rnd, results)
                stops = _after_iteration(session, callbacks, forest, rnd, evals_log)
                rnd += 1
                if any(stops):
                    stop = True
                    break

        for cb in callbacks:
            if hasattr(cb, "after_training"):
                forest = cb.after_training(forest) or forest
    finally:
        session.release_graph()
        _clear_comm_round_fields()
    return forest
