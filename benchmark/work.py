"""The least work of a boosting round, counted from shapes and the traced
trees in the benchmark's own arithmetic.

It reads the same whatever implements the round: each input byte is
counted once and each output byte once, and where the work depends on the
tree, what the tree's rows need (``judge.node_counts``). A histogram at a
level after the root (depthwise) or of a split step (lossguide) counts
only the smaller child of each pair, the least any subtraction builder
needs. The constants:

* a histogram: per row its ``d`` bins (1 byte each below 257 bins, else 2),
  its gradient and hessian (8 bytes) and its node id (4 bytes); out,
  ``d * num_bins`` gradient and hessian sums (8 bytes each); 2 adds per row
  and feature;
* the last level's node totals (depthwise): per row at that level its
  gradient, hessian and node id (12 bytes), 2 adds; out, 8 bytes a node;
* routing: per row at an internal node, the split column's bin, its node
  id read and written (bin bytes + 8);
* the gradient pass: per row the label and margin read, g and h written
  (16 bytes); 8 operations a row for ``binary:logistic``; for
  ``rank:ndcg`` 16 operations per pair of documents of one query whose
  labels differ (the score difference, the exponential, the sigmoid,
  |delta NDCG| and the four accumulations);
* the training margins: per row its leaf's value added (12 bytes);
* the validation margins: per validation row at each internal node its
  split column's bin, and 12 bytes a row.
"""

import numpy as np

HIST_ROW_EXTRA = 12       # gradient + hessian + node id
ROUTE_EXTRA = 8           # node id read + written
GRAD_BYTES = 16
LOGISTIC_OPS = 8
PAIR_OPS = 16
MARGIN_BYTES = 12


def bin_bytes(num_bins):
    return 1 if num_bins <= 256 else 2


def ranking_pairs(labels, groups):
    """Pairs of documents of one query whose labels differ."""
    labels = np.asarray(labels).astype(np.int64)
    q = np.repeat(np.arange(len(groups)), groups)
    levels = int(labels.max()) + 1
    cnt = np.zeros((len(groups), levels), np.int64)
    np.add.at(cnt, (q, labels), 1)
    total = 0
    for a in range(levels):
        for b in range(a + 1, levels):
            total += int((cnt[:, a] * cnt[:, b]).sum())
    return total


def _hist(rows, nodes, d, num_bins):
    nbytes = rows * (d * bin_bytes(num_bins) + HIST_ROW_EXTRA) + nodes * d * num_bins * 8
    return nbytes, 2.0 * rows * d


def round_work(tree, depth, counts, valid_counts, p, d, num_bins, objective, pairs=0):
    """-> {"hist_calls": [(bytes, adds)], "bytes": round total, "ops": round
    total} of one round's tree (the judge's arrays, slot depths, rows a
    slot)."""
    is_leaf = np.asarray(tree["is_leaf"])
    left, right = np.asarray(tree["left"]), np.asarray(tree["right"])
    internal = np.nonzero((~is_leaf) & (depth >= 0))[0]
    bb = bin_bytes(num_bins)
    n, nv = counts[0], valid_counts[0]
    calls = [_hist(n, 1, d, num_bins)]
    if p["grow_policy"] == "lossguide":
        for s in internal:
            calls.append(_hist(min(counts[left[s]], counts[right[s]]), 1, d, num_bins))
    else:
        D = p["max_depth"]
        for level in range(1, D):
            parents = internal[depth[internal] == level - 1]
            rows = sum(min(counts[left[s]], counts[right[s]]) for s in parents)
            calls.append(_hist(rows, len(parents), d, num_bins))
        last = np.nonzero(depth == D)[0]
        rows = float(counts[last].sum())
        calls.append((rows * HIST_ROW_EXTRA + 2 ** D * 8, 2.0 * rows))
    nbytes = sum(c[0] for c in calls)
    ops = sum(c[1] for c in calls)
    nbytes += counts[internal].sum() * (bb + ROUTE_EXTRA)
    nbytes += n * (GRAD_BYTES + MARGIN_BYTES)
    ops += pairs * PAIR_OPS if objective == "rank:ndcg" else n * LOGISTIC_OPS
    nbytes += valid_counts[internal].sum() * bb + nv * MARGIN_BYTES
    return {"hist_calls": calls, "bytes": float(nbytes), "ops": float(ops)}


def least_seconds(nbytes, ops, peaks):
    """The roofline's least time of ``nbytes`` and ``ops`` on the chip."""
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["f32_ops_per_s"])
