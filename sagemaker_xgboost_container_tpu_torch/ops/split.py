"""Split finding: gain scan over level histograms.

XGBoost split semantics: L1 thresholding (alpha), L2 smoothing (lambda),
gamma complexity penalty, min_child_weight pruning, and sparsity-aware
missing direction (both placements of the missing bucket are scored and the
larger decides ``default_left``).

Histograms are [W, d, B] with B = max_bin + 1 (last slot = missing); the
scan considers splits at bins 0..B-2 masked by each feature's cut count and,
under column sampling, by a feature mask.
"""

import collections

import torch

from ..parallel import collectives

# A tree's column-sampling masks (f32 1 = usable, 0 = not), each None when
# that knob is off, each with a leading axis of 1 (shared by the classes of a
# multiclass round) or C (one per class axis entry, e.g. CV folds):
#   tree  [C, d]     colsample_bytree's column set
#   level [C, L, d]  colsample_bylevel, one row per depth
#   node  [C, S, d]  colsample_bynode, one row per node slot
ColumnMasks = collections.namedtuple("ColumnMasks", ["tree", "level", "node"])


def combine_masks(*masks):
    """Product of the masks that are not None (0/1 values, so an AND), or
    None when every one is None."""
    out = None
    for m in masks:
        if m is not None:
            out = m if out is None else out * m
    return out


def _node_feature_mask(feature_mask, W):
    """A [d], [W, d] or class-axis [C, W/C or 1, d] mask -> [W or 1, d]."""
    if feature_mask.dim() == 1:
        return feature_mask[None]
    if feature_mask.dim() == 2:
        return feature_mask
    C = feature_mask.shape[0]
    return feature_mask.expand(C, W // C, -1).reshape(W, -1)


def _threshold_l1(g, alpha):
    return torch.sign(g) * torch.clamp(torch.abs(g) - alpha, min=0.0)


def _score(g, h, reg_lambda, alpha):
    t = _threshold_l1(g, alpha)
    return (t * t) / (h + reg_lambda)


def find_best_splits(
    G,
    H,
    num_cuts,
    reg_lambda=1.0,
    alpha=0.0,
    gamma=0.0,
    min_child_weight=1.0,
    feature_mask=None,
    monotone=None,
    totals=None,
):
    """Best (feature, bin, default_dir, gain) per node at one level.

    Args:
      G, H: f32 [W, d, B] level histograms (B includes the missing slot).
      num_cuts: i32 [d] — number of real cut thresholds per feature; splits
        are only legal at bin < num_cuts[f].
      feature_mask: optional colsample mask, 1 = usable: [d], [W, d] per
        node, or with the class axis (the builder's C*W nodes, class-major)
        [C, d] given as [C, 1, d], or [C, W/C, d]. A feature it zeroes has
        every candidate at -inf before the argmax.
      monotone: optional i32 [d] in {-1, 0, 1}: a candidate on a feature
        with +1 (-1) needs its left child's weight at most (at least) its
        right child's; the order of a split's two children only, as in the
        JAX package (no bounds pass down from ancestors).
      totals: optional (g_total, h_total) f32 [W] overriding the feature-0
        derivation: needed where G, H are a reduce-scattered feature slice
        (``broadcast_node_totals``), whose local feature 0 is another global
        feature on every rank.

    Returns dict of per-node tensors (length W): gain f32, feature i32,
    bin i32, default_left bool, plus node totals g_total/h_total f32. Ties
    go to the first index of the max over the flattened (feature, bin)
    axis, as ``torch.argmax`` returns the first maximal index.
    """
    W, d, B = G.shape
    nbins = B - 1  # data bins
    if totals is None:
        # node totals: every row lands in exactly one bin of feature 0
        g_total = G[:, 0, :].sum(dim=-1)
        h_total = H[:, 0, :].sum(dim=-1)
    else:
        g_total, h_total = totals

    g_miss = G[:, :, nbins]  # [W, d]
    h_miss = H[:, :, nbins]
    g_cum = torch.cumsum(G[:, :, :nbins], dim=-1)
    h_cum = torch.cumsum(H[:, :, :nbins], dim=-1)

    parent = _score(g_total, h_total, reg_lambda, alpha)[:, None, None]
    # a fill, not a copy from the host, which would wait for the device
    neg_inf = torch.full((), float("-inf"), device=G.device)

    def _gain(gl, hl):
        gr = g_total[:, None, None] - gl
        hr = h_total[:, None, None] - hl
        ok = (hl >= min_child_weight) & (hr >= min_child_weight)
        raw = 0.5 * (
            _score(gl, hl, reg_lambda, alpha)
            + _score(gr, hr, reg_lambda, alpha)
            - parent
        ) - gamma
        if monotone is not None:
            wl = -_threshold_l1(gl, alpha) / (hl + reg_lambda)
            wr = -_threshold_l1(gr, alpha) / (hr + reg_lambda)
            mono = monotone.to(G.device)[None, :, None]
            ok = ok & torch.where(mono == 0, True, torch.where(mono > 0, wl <= wr, wl >= wr))
        return torch.where(ok, raw, neg_inf)

    gain_right = _gain(g_cum, h_cum)                          # missing -> right
    gain_left = _gain(g_cum + g_miss[:, :, None], h_cum + h_miss[:, :, None])

    # mask: split bin must be a real cut of this feature
    bin_ids = torch.arange(nbins, device=G.device)[None, :]
    legal = (bin_ids < num_cuts.to(G.device)[:, None])[None, :, :]  # [1, d, nbins]
    if feature_mask is not None:
        legal = legal & (_node_feature_mask(feature_mask, W) > 0)[:, :, None]
    gain_right = torch.where(legal, gain_right, neg_inf)
    gain_left = torch.where(legal, gain_left, neg_inf)

    take_left = gain_left > gain_right
    gain = torch.where(take_left, gain_left, gain_right)      # [W, d, nbins]

    flat = gain.reshape(W, d * nbins)
    best_idx = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best_idx[:, None])[:, 0]
    best_default_left = torch.gather(
        take_left.reshape(W, d * nbins), 1, best_idx[:, None]
    )[:, 0]
    return {
        "gain": torch.where(torch.isfinite(best_gain), best_gain, neg_inf),
        "feature": torch.div(best_idx, nbins, rounding_mode="floor").int(),
        "bin": (best_idx % nbins).int(),
        "default_left": best_default_left,
        "g_total": g_total,
        "h_total": h_total,
    }


def leaf_weight(g, h, reg_lambda=1.0, alpha=0.0, max_delta_step=0.0):
    """Optimal leaf weight -T(g)/(h+lambda), clipped by max_delta_step."""
    w = -_threshold_l1(g, alpha) / (h + reg_lambda)
    if max_delta_step > 0:
        w = torch.clamp(w, -max_delta_step, max_delta_step)
    return w


# ------------------------------------------------------ data-axis merge


def combine_splits_across_shards(splits, shard, d_local, group):
    """Merge per-rank best splits of a feature-sliced scan over ``group``.

    Under ``GRAFT_HIST_COMM=reduce_scatter`` each rank scanned only its
    feature slice [shard * d_local, (shard + 1) * d_local) of the summed
    histograms. The winner is the max gain, ties going to the lowest global
    feature id (the argmax of one scan over every column), and the winner's
    feature, bin and default_left are summed from the one rank that owns it,
    so that every rank ends with the same splits. Node totals pass through:
    ``broadcast_node_totals`` made them identical before the scan. Three
    calls (max, min, one stacked sum) carry the JAX package's five.
    """
    global_feat = splits["feature"] + shard * d_local
    gain = splits["gain"]
    best_gain = collectives.all_reduce(gain.clone(), group, op="max", kind="merge")
    is_tied_winner = gain == best_gain
    cand = torch.where(is_tied_winner, global_feat, torch.full_like(global_feat, 2**30))
    win_feat = collectives.all_reduce(cand, group, op="min", kind="merge")
    i_own = is_tied_winner & (global_feat == win_feat)
    picked = torch.stack([global_feat, splits["bin"], splits["default_left"].int()])
    picked = collectives.all_reduce(torch.where(i_own, picked, 0), group, kind="merge")
    return {
        "gain": best_gain,
        "feature": picked[0],
        "bin": picked[1],
        "default_left": picked[2] > 0,
        "g_total": splits["g_total"],
        "h_total": splits["h_total"],
    }


def concat_node_splits(parts, dim=0):
    """Concatenate per-node-batch ``find_best_splits`` results along the
    node axis: the scan is independent per node, so batches concatenate to
    the whole-level scan bit for bit. A single batch passes through."""
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts], dim=dim) for k in parts[0]}


def broadcast_node_totals(G, H, shard, group):
    """Per-node (sum g, sum h) for the reduce_scatter lowering: the rank
    owning global feature 0 (shard 0) sums its feature-0 bins, the others
    add zeros, so that every rank's gains use the totals the psum lowering
    derives, bit for bit. One call for the pair."""
    gh = torch.stack([G[:, 0, :].sum(dim=-1), H[:, 0, :].sum(dim=-1)])
    if shard != 0:
        gh = torch.zeros_like(gh)
    gh = collectives.all_reduce(gh, group, kind="merge")
    return gh[0], gh[1]


def shard_feature_slice(arr, shard, d_local, axis_size):
    """This rank's contiguous feature slice of a per-feature tensor [..., d]:
    zero-padded to ``d_local * axis_size``, then [shard * d_local, (shard +
    1) * d_local). Zero padding is inert for every consumer: num_cuts 0 = no
    legal split bin, feature_mask 0 = masked, monotone 0 = unconstrained."""
    d = arr.shape[-1]
    d_pad = d_local * axis_size
    if d_pad != d:
        arr = torch.nn.functional.pad(arr, (0, d_pad - d))
    return arr[..., shard * d_local:(shard + 1) * d_local]
