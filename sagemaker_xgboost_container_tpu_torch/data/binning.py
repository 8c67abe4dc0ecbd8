"""Weighted quantile binning: DataMatrix -> BinnedMatrix.

The trainer never touches raw floats: it consumes a compact uint8/uint16
matrix of per-feature bin indices, so the per-round histogram build is an
integer scatter-add.

* Cut points are midpoints between adjacent selected quantile values, so the
  binned decision ``bin(v) <= b`` is exactly the float decision
  ``v < cut[b]``: trained trees serialize to xgboost ``split_condition``
  thresholds with no train/serve skew.
* One shared missing bin at index ``max_bin``; values 0..max_bin-1 are real
  bins. ``max_bin + 1`` slots in all, so ``max_bin=256`` needs uint16.
* Cut selection has two lowerings, as in the JAX package: the host sketch
  (numpy, a loop over features), bitwise equal to the JAX package's host
  path, and a device sketch (torch ops over all features at once, on the
  tensors' device), which follows the JAX package's device lowering step for
  step. ``GRAFT_SKETCH_IMPL`` picks one (``_sketch_impl``).
* ``max_bin=None`` (``tree_method=exact``) takes every adjacent-distinct
  midpoint, so the bin width is sized by the data, bounded by ``exact_cap``.
* ``bin_matrix`` times its two parts as the phases ``setup.sketch`` (the
  cuts) and ``setup.apply`` (the binning; the host's enqueue where it runs
  on a card), once a matrix (``telemetry.span``: the registry's
  ``training_phase_seconds``).
"""

import os

import numpy as np
import torch

from ..telemetry import span
from ..toolkit import exceptions as exc


class BinnedMatrix:
    """Bin-index features + cut points + labels/weights/groups.

    ``models/booster.train`` also takes one directly as a pre-binned
    training or eval input: the streaming ingest (``data/streaming.py``)
    makes one without ever holding the float channel, and the session then
    skips its own sketch and binning and trusts these cuts. A pre-binned
    matrix has no ``features``: what needs floats goes through
    ``rep_block``, bounded blocks of representative values that route
    through every tree exactly as the original floats do.
    """

    def __init__(self, bins, cut_points, max_bin, labels=None, weights=None, groups=None,
                 feature_names=None):
        self.bins = bins                  # uint8/uint16 [n, d]; max_bin == missing
        self.cut_points = cut_points      # list of d float32 ascending arrays
        self.max_bin = int(max_bin)       # missing-bin index; num_bins = max_bin + 1
        self.labels = labels
        self.weights = weights
        self.groups = groups
        self.feature_names = list(feature_names) if feature_names is not None else None

    @property
    def num_row(self):
        return self.bins.shape[0]

    @property
    def num_col(self):
        return self.bins.shape[1]

    @property
    def num_bins(self):
        return self.max_bin + 1

    def get_label(self):
        return self.labels if self.labels is not None else np.empty(0, dtype=np.float32)

    def get_weight(self):
        if self.weights is None:
            return np.ones(self.num_row, dtype=np.float32)
        return self.weights

    @property
    def features(self):
        # a pre-binned matrix reaching a float-features consumer is a wiring
        # bug: never hand out representative values where the original
        # floats are expected
        raise exc.AlgorithmError(
            "BinnedMatrix has no float features (chunked ingest never "
            "materializes the channel); use rep_block() for routing-exact "
            "representative values or gate this path off pre-binned input"
        )

    def rep_block(self, start, end):
        """Representative float rows ``[start:end)``, routing-exact.

        Every committed threshold is a cut of ``cut_points``, and a value in
        bin b satisfies ``v < cut[i]`` iff ``b <= i``. The representative
        of bin b >= 1 is ``cut[b-1]``, of bin 0 the f32 just below
        ``cut[0]``, of the missing bin NaN: each satisfies the same
        equivalence, so a prediction from these blocks routes every row to
        the leaf its original floats reach."""
        bins = np.asarray(self.bins[start:end])
        out = np.empty(bins.shape, np.float32)
        for f in range(self.num_col):
            cuts = np.asarray(self.cut_points[f], np.float32)
            lookup = np.full(self.max_bin + 1, np.nan, np.float32)
            if cuts.size:
                # both arguments f32: nextafter of an f32 against a Python
                # float goes through f64 and rounds back onto cuts[0]
                lookup[0] = np.nextafter(cuts[0], np.float32(-np.inf))
                lookup[1:cuts.size + 1] = cuts
            else:
                lookup[0] = 0.0  # no cuts: never split on, the value is inert
            out[:, f] = lookup[bins[:, f]]
        return out


def _select_cuts(sorted_values, sorted_weights, max_cuts):
    """Pick <= max_cuts cut thresholds from one feature's non-missing values.

    sorted_values: ascending, may contain duplicates. Returns midpoints
    between adjacent *distinct* representative values.
    """
    if sorted_values.size == 0:
        return np.empty(0, dtype=np.float32)
    distinct, start_idx = np.unique(sorted_values, return_index=True)
    if distinct.size <= max_cuts:
        reps = distinct
    else:
        # weighted quantiles: cumulative weight at the *end* of each distinct
        # value's run, evaluated at evenly spaced targets
        cum = np.cumsum(sorted_weights)
        total = cum[-1]
        run_end = np.append(start_idx[1:], len(sorted_values)) - 1
        cum_at_distinct = cum[run_end]
        targets = total * (np.arange(1, max_cuts + 1) / (max_cuts + 1))
        picks = np.searchsorted(cum_at_distinct, targets, side="left")
        picks = np.unique(np.clip(picks, 0, distinct.size - 1))
        reps = distinct[picks]
    if reps.size < 2:
        # one distinct value -> no informative split; place one cut above it
        # so "value present" vs "missing" can still separate
        return np.asarray([reps[0] + 1.0 if reps.size else 0.0], dtype=np.float32)
    mids = (reps[:-1] + reps[1:]) / 2.0
    return mids.astype(np.float32)


def cuts_from_summaries(summaries, max_bin):
    """Per-feature cuts from merged (distinct values, weight sums) summaries,
    one pair a feature (the streaming ingest's sketch, ``data/streaming.py``):
    values strictly ascending f32, weights the total weight seen at each.
    Runs the host ``_select_cuts``: ``np.unique`` over distinct values is
    the identity, so the cumulative weight at each run end is
    ``cumsum(weights)``, and for unit (and f32-exact integer) row weights
    the cuts are bitwise those of ``compute_cut_points`` over the flat
    channel. Float row weights can differ in the last ulp of a cumulative
    sum (summed chunk by chunk), which can move a quantile pick on the edge
    by one distinct value."""
    if max_bin is None:
        raise exc.UserError(
            "tree_method='exact' (max_bin=None) is not supported by chunked "
            "ingest; use tree_method='hist' or SM_INGEST_MODE=whole."
        )
    max_cuts = max_bin - 1
    return [
        _select_cuts(np.asarray(values, np.float32), np.asarray(weights, np.float32), max_cuts)
        for values, weights in summaries
    ]


def _sketch_impl(device=None):
    """host | device lowering of the sketch (``GRAFT_SKETCH_IMPL``, default
    auto). ``auto`` takes the device lowering where ``device`` is a CUDA
    device, the port's counterpart of the JAX package's choice on the TPU:
    the approx re-sketch and ``apply_cut_points`` pass their session's
    device; every initial cut selection passes none and keeps the host
    lowering."""
    v = os.environ.get("GRAFT_SKETCH_IMPL", "auto")
    if v == "auto":
        return "device" if device is not None and torch.device(device).type == "cuda" else "host"
    if v not in ("host", "device"):
        raise ValueError("GRAFT_SKETCH_IMPL must be auto|host|device")
    return v


def device_cut_points(feats, w, max_cuts):
    """The device lowering of the cut selection, on ``feats``' device:
    f32 [n, d] features and [n] weights -> (mids f32 [d, max_cuts], the
    feature's count of cuts i64 [d]; mids past a feature's count are
    padding).

    The JAX package's ``_device_cut_points`` as torch ops on [d, n] columns,
    all features at once: sort, cumulative weight at the end of each
    distinct value's run, f32 quantile targets, left searchsorted, the picks
    deduplicated, midpoints of adjacent representatives; every distinct
    value where a feature has at most ``max_cuts``, one cut above the value
    of a single-valued feature, none for an all-missing one.

    The JAX program sorts on two keys (the value with NaN as +inf, then the
    missing flag), so that a real +inf comes before the missing tail.
    ``torch.sort`` orders NaN after +inf, so one stable sort of the raw
    values gives that order: finite values ascending, then +inf, then NaN,
    each run of equal values in row order. Missing rows weigh 0.

    Like the JAX device lowering, not bitwise equal to the host sketch:
    the cumulative weights and the targets are f32 here, where the host
    sums in f32 against f64 targets, so a target on the edge can move one
    pick by one distinct value.
    """
    n, d = feats.shape
    L = max(n, max_cuts)
    dev = feats.device
    inf = torch.full((), float("inf"), device=dev)
    cols = feats.T.contiguous()
    sv, order = torch.sort(cols, dim=1, stable=True)
    snan = torch.isnan(sv)
    valid = ~snan
    sw = torch.where(valid, w[order], torch.zeros((), device=dev))
    cw = torch.cumsum(sw, dim=1)  # missing rows weigh 0 at the tail
    nxt = torch.cat([sv[:, 1:], inf.expand(d, 1)], dim=1)
    nxt_invalid = torch.cat([snan[:, 1:], torch.ones((d, 1), dtype=torch.bool, device=dev)],
                            dim=1)
    is_end = valid & ((sv != nxt) | nxt_invalid)
    pos = torch.cumsum(is_end.int(), dim=1) - 1
    n_distinct = torch.clamp(pos[:, -1] + 1, min=0)
    # run ends scattered to their rank; the rest to the dropped slot L
    slot = torch.where(is_end, pos, L).long()
    distinct = torch.full((d, L + 1), float("inf"), device=dev).scatter_(
        1, slot, torch.where(is_end, sv, inf))[:, :L]
    cum_at = torch.full((d, L + 1), float("inf"), device=dev).scatter_(
        1, slot, torch.where(is_end, cw, inf))[:, :L]
    total = cw[:, -1:]
    targets = total * (torch.arange(1, max_cuts + 1, dtype=torch.float32, device=dev)
                       / (max_cuts + 1))
    picks = torch.searchsorted(cum_at.contiguous(), targets.contiguous(), side="left")
    picks = torch.minimum(picks, torch.clamp(n_distinct - 1, min=0)[:, None])
    uniq = torch.cat([torch.ones((d, 1), dtype=torch.bool, device=dev),
                      picks[:, 1:] != picks[:, :-1]], dim=1)
    upos = torch.cumsum(uniq.int(), dim=1) - 1
    reps_b = torch.full((d, max_cuts + 2), float("inf"), device=dev).scatter_(
        1, torch.where(uniq, upos, max_cuts + 1).long(),
        torch.where(uniq, torch.gather(distinct, 1, picks), inf))[:, :max_cuts]
    n_b = uniq.sum(dim=1)
    use_all = n_distinct <= max_cuts
    reps = torch.where(use_all[:, None], distinct[:, :max_cuts], reps_b)
    n_reps = torch.where(use_all, n_distinct, n_b)
    mids = torch.cat([(reps[:, :-1] + reps[:, 1:]) * 0.5,
                      torch.zeros((d, 1), device=dev)], dim=1)
    single = n_reps == 1
    mids[:, 0] = torch.where(single, reps[:, 0] + 1.0, mids[:, 0])
    n_cuts = torch.where(n_reps == 0, 0, torch.where(single, 1, n_reps - 1))
    return mids, n_cuts


def device_apply(feats, mids, n_cuts, max_bin):
    """The device lowering of ``apply_cut_points``: f32 [n, d] features and
    padded cuts (``device_cut_points``' outputs) -> [n, d] bin indices,
    uint8 or uint16 as ``apply_cut_points`` gives them, on ``feats``'
    device. One searchsorted over all features; +inf values land on the
    feature's count of cuts, as numpy's searchsorted puts them."""
    cols = feats.T.contiguous()
    pad = torch.arange(mids.shape[1], device=mids.device)[None, :] >= n_cuts[:, None]
    cuts = torch.where(pad, torch.full((), float("inf"), device=mids.device), mids)
    idx = torch.searchsorted(cuts.contiguous(), cols, side="right", out_int32=True)
    idx = torch.minimum(idx, n_cuts.int()[:, None])
    idx = torch.where(torch.isnan(cols), max_bin, idx).T.contiguous()
    if max_bin + 1 <= 256:
        return idx.to(torch.uint8)
    # every index fits in int16 after the shift, so the cast is exact
    return torch.where(idx >= 32768, idx - 65536, idx).to(torch.int16).view(torch.uint16)


def cut_lists(mids, n_cuts):
    """Padded device cuts -> one float32 numpy array a feature."""
    mids = mids.cpu().numpy()
    return [mids[f, :c].copy() for f, c in enumerate(n_cuts.cpu().numpy().tolist())]


def compute_cut_points(features, weights=None, max_bin=256, device=None):
    """Per-feature cut thresholds via weighted quantiles. NaN = missing.

    ``max_bin=None`` selects every adjacent-distinct midpoint (no quantile
    subsetting): the candidate set and thresholds of xgboost's exact greedy
    enumeration, made static-shape by binning. Under the device lowering
    (``_sketch_impl``; never for ``max_bin=None``, as in the JAX package)
    the sketch runs on ``device``, the CPU when it is None.
    """
    n, d = features.shape
    if max_bin is not None and max_bin < 2:
        raise exc.UserError("max_bin must be at least 2")
    w = np.ones(n, dtype=np.float32) if weights is None else weights
    max_cuts = n if max_bin is None else max_bin - 1
    if max_bin is not None and n > 0 and _sketch_impl() == "device":
        dev = torch.device("cpu") if device is None else torch.device(device)
        mids, n_cuts = device_cut_points(
            torch.as_tensor(np.asarray(features, np.float32), device=dev),
            torch.as_tensor(np.asarray(w, np.float32), device=dev), max_cuts)
        return cut_lists(mids, n_cuts)
    cuts = []
    if weights is None:
        # unit weights: the sorted values alone decide the cuts, so a sort
        # (no permutation to carry weights) of each contiguous column, several
        # times faster than the stable argsort. Equal values may come in
        # another order (-0.0 and 0.0), which no cut sees: a cut is a
        # midpoint of distinct values
        ones = np.ones(n, np.float32)
        for col in np.ascontiguousarray(np.asarray(features).T):
            col = np.sort(col)
            valid = n - int(np.count_nonzero(np.isnan(col)))  # NaN sorts last
            cuts.append(_select_cuts(col[:valid], ones[:valid], max_cuts))
        return cuts
    order = np.argsort(features, axis=0, kind="stable")
    for f in range(d):
        col = features[order[:, f], f]
        colw = w[order[:, f]]
        valid = ~np.isnan(col)
        cuts.append(_select_cuts(col[valid], colw[valid], max_cuts))
    return cuts


def pad_cut_points(cut_points, device):
    """Per-feature cut lists -> (f32 [d, L] padded with +inf, i64 [d]
    counts) on ``device``: ``device_apply``'s inputs."""
    L = max(1, max((len(c) for c in cut_points), default=1))
    padded = np.full((len(cut_points), L), np.inf, np.float32)
    for f, c in enumerate(cut_points):
        padded[f, :len(c)] = c
    counts = np.asarray([len(c) for c in cut_points], np.int64)
    return torch.as_tensor(padded, device=device), torch.as_tensor(counts, device=device)


def apply_cut_points(features, cut_points, max_bin, device=None):
    """Map float features to bin indices; NaN -> missing bin (== max_bin).
    Under the device lowering (``_sketch_impl(device)``: ``auto`` on a CUDA
    ``device``, as the JAX package applies on the TPU) the searchsorted runs
    on ``device`` (the CPU when None) and the bins come back to the host;
    either lowering gives the same bins."""
    n, d = features.shape
    dtype = np.uint8 if max_bin + 1 <= 256 else np.uint16
    if n > 0 and d > 0 and _sketch_impl(device) == "device":
        dev = torch.device("cpu") if device is None else torch.device(device)
        mids, n_cuts = pad_cut_points(cut_points, dev)
        feats = torch.as_tensor(np.asarray(features, np.float32), device=dev)
        return device_apply(feats, mids, n_cuts, max_bin).cpu().numpy()
    bins = np.empty((n, d), dtype=dtype)
    for f in range(d):
        col = features[:, f]
        idx = np.searchsorted(cut_points[f], col, side="right")
        idx[np.isnan(col)] = max_bin
        bins[:, f] = idx.astype(dtype)
    return bins


def bin_matrix(dmatrix, max_bin=256, cut_points=None, exact_cap=None, device=None):
    """DataMatrix -> BinnedMatrix (computing cuts unless provided).

    ``max_bin=None`` is exact-greedy binning: cuts at every adjacent-distinct
    midpoint, and the bin width sized by the data. ``exact_cap`` bounds that
    width: per-node histograms are O(nodes x features x bins), so a column
    with too many distinct values fails loudly rather than exhausting device
    memory. ``device``: where the device lowering runs (``_sketch_impl``).
    """
    if cut_points is None:
        with span("setup.sketch"):
            cut_points = compute_cut_points(dmatrix.features, dmatrix.weights, max_bin,
                                            device=device)
    longest = max((len(c) for c in cut_points), default=0)
    if max_bin is None:
        max_bin = longest + 1
        if exact_cap is not None and max_bin > exact_cap:
            raise exc.UserError(
                "tree_method='exact' needs {} bins for this data (one per "
                "distinct feature value), above the exact-method cap of {}. Use "
                "tree_method='hist' (quantile binning), or raise "
                "GRAFT_EXACT_BIN_CAP if the memory cost is acceptable.".format(
                    max_bin, exact_cap
                )
            )
        if max_bin + 1 > 65536:
            raise exc.AlgorithmError(
                "exact binning needs {} bins; the uint16 bin matrix holds "
                "at most 65535".format(max_bin)
            )
    elif longest + 1 > max_bin:
        raise exc.AlgorithmError(
            "cut selection produced {} cuts for max_bin {}".format(longest, max_bin)
        )
    with span("setup.apply"):
        bins = apply_cut_points(dmatrix.features, cut_points, max_bin, device=device)
    return BinnedMatrix(
        bins, cut_points, max_bin, labels=dmatrix.labels, weights=dmatrix.weights,
        groups=dmatrix.groups,
    )
