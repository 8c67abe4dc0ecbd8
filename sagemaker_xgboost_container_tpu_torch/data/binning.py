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
* Cut selection is the exact host sketch (numpy), bitwise equal to the JAX
  package's host path.
"""

import numpy as np

from ..toolkit import exceptions as exc


class BinnedMatrix:
    """Bin-index features + cut points + labels/weights."""

    def __init__(self, bins, cut_points, max_bin, labels=None, weights=None):
        self.bins = bins                  # uint8/uint16 [n, d]; max_bin == missing
        self.cut_points = cut_points      # list of d float32 ascending arrays
        self.max_bin = int(max_bin)       # missing-bin index; num_bins = max_bin + 1
        self.labels = labels
        self.weights = weights

    @property
    def num_bins(self):
        return self.max_bin + 1


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


def compute_cut_points(features, weights=None, max_bin=256):
    """Per-feature cut thresholds via weighted quantiles. NaN = missing."""
    n, d = features.shape
    if max_bin < 2:
        raise exc.UserError("max_bin must be at least 2")
    w = np.ones(n, dtype=np.float32) if weights is None else weights
    max_cuts = max_bin - 1
    cuts = []
    order = np.argsort(features, axis=0, kind="stable")
    for f in range(d):
        col = features[order[:, f], f]
        colw = w[order[:, f]]
        valid = ~np.isnan(col)
        cuts.append(_select_cuts(col[valid], colw[valid], max_cuts))
    return cuts


def apply_cut_points(features, cut_points, max_bin):
    """Map float features to bin indices; NaN -> missing bin (== max_bin)."""
    n, d = features.shape
    dtype = np.uint8 if max_bin + 1 <= 256 else np.uint16
    bins = np.empty((n, d), dtype=dtype)
    for f in range(d):
        col = features[:, f]
        idx = np.searchsorted(cut_points[f], col, side="right")
        idx[np.isnan(col)] = max_bin
        bins[:, f] = idx.astype(dtype)
    return bins


def bin_matrix(dmatrix, max_bin=256, cut_points=None):
    """DataMatrix -> BinnedMatrix (computing cuts unless provided)."""
    if cut_points is None:
        cut_points = compute_cut_points(dmatrix.features, dmatrix.weights, max_bin)
    longest = max((len(c) for c in cut_points), default=0)
    if longest + 1 > max_bin:
        raise exc.AlgorithmError(
            "cut selection produced {} cuts for max_bin {}".format(longest, max_bin)
        )
    bins = apply_cut_points(dmatrix.features, cut_points, max_bin)
    return BinnedMatrix(
        bins, cut_points, max_bin, labels=dmatrix.labels, weights=dmatrix.weights
    )
