"""Leaf-wise (lossguide) tree growth: best-gain-first splitting to max_leaves.

The JAX package's ``ops/lossguide.py``, as an eager loop:

* node slots are allocated in order (root 0; split step t creates 2t+1 and
  2t+2), with explicit child indices: the tree layout of ``tree_build``;
* ``max_leaves - 1`` split steps; each picks the leaf with the best stored
  candidate gain, routes its rows, and histograms the two fresh children
  (only the left one when sibling subtraction is on: the right one is the
  cached parent minus the left);
* every leaf keeps its best-split candidate, so a step's pick is a max over
  node slots, not over rows.

A step that cannot split (no leaf gains more than ``MIN_SPLIT_LOSS``) is
masked, never branched on: the loop enqueues every step's work without
waiting for the device, and such a step changes nothing.

C trees (one per class of a multiclass round) grow together on ``[C, n]``
gradients: each step is one histogram launch for all classes, and each class
picks its own leaf.

Column sampling (``ColumnMasks``, drawn by ``models/sampling``), as the JAX
package's lossguide applies it: the tree's column set everywhere; the
bylevel row of a node's depth (capped at the depth limit) when its
candidate is scored, a depth that differs per class; and for the two
children of split step t, the bynode rows of their slots 2t+1 and 2t+2
(the root draws none).

Data-parallel training (``group``), as in the JAX package's data-axis
path: the root's and every step's histograms are reduced over the process
group before their scan (with subtraction, the left child's; the right one
is the reduced parent minus it), so every rank keeps the same candidate
store and picks the same leaf. ``hist_comm`` ``reduce_scatter`` scans this
rank's feature slice and merges the winners across ranks.

The feature axis (``feature_group``), as ``build_tree`` takes it: the root's
and every step's scan runs on this feature shard's columns and merges over
the feature group (``merged_scan``), so every shard keeps the same
candidate store with global feature ids; a step's rows are routed by the
shard that owns the picked leaf's feature, its decisions summed over the
group (``route_rows``).

Constraints per slot, as in the JAX package: ``monotone`` in the split scan;
``interaction_sets`` alive at each slot (all at the root; the two children of
a step keep the sets of their parent that hold its split feature), a slot's
candidate drawn from the features of its alive sets.
"""

import torch

from ..parallel import collectives
from .histogram import (
    apply_hist_collective,
    comm_overlap,
    level_histogram,
    overlap_node_batches,
    padded_feature_width,
    subtraction_enabled,
)
from .split import (
    column_shard_helpers,
    combine_masks,
    concat_node_splits,
    leaf_weight,
    shard_feature_slice,
)
from .stamps import HISTOGRAM, PARTITION, SPLIT
from .tree_build import MIN_SPLIT_LOSS, merged_scan, route_rows


def _subtraction_enabled(max_leaves, d, num_bins):
    """Sibling subtraction for leaf-wise growth: needs a [2*max_leaves-1, d,
    B] f32 cache of G and H per class, gated by the shared memory cap."""
    return subtraction_enabled(2 * (2 * max_leaves - 1) * d * num_bins * 4)


def build_tree_lossguide(
    bins,
    grad,
    hess,
    num_cuts,
    max_leaves,
    num_bins,
    max_depth=0,
    reg_lambda=1.0,
    alpha=0.0,
    gamma=0.0,
    min_child_weight=1.0,
    eta=0.3,
    max_delta_step=0.0,
    masks=None,
    monotone=None,
    interaction_sets=None,
    group=None,
    hist_comm="psum",
    feature_group=None,
    n_feature_shards=1,
    d_global=None,
    stamp=None,
):
    """Grow one leaf-wise tree on grad, hess [n], or C trees on [C, n].
    Returns (tree tensors dict, row_out f32 [n] or [C, n]).

    The tree dict has ``build_tree``'s keys, each of length
    ``2 * max_leaves - 1`` (or [C, that]); slots no split created stay
    self-looped leaves. ``max_depth`` 0 leaves the depth unbounded (at most
    ``max_leaves - 1``).

    ``masks``: optional ``ColumnMasks`` with ``level`` [1 or C, depth cap +
    1, d] (the depth cap is ``max_depth``, or ``max_leaves`` when it is 0)
    and ``node`` [1 or C, 2 * max_leaves - 1, d] (one row per node slot).
    ``monotone``: optional i32 [d] in {-1, 0, 1}; ``interaction_sets``:
    optional bool [S, d], one row a constraint set (``build_tree``'s).
    ``group`` / ``hist_comm``: data-parallel training, and
    ``feature_group`` / ``n_feature_shards`` / ``d_global``: the feature
    axis, as ``build_tree`` takes them. ``stamp``: a ``StageClock`` or None,
    as ``build_tree`` takes it; a step stamps its pick (``split``), its
    routing and the children's row keys (``partition``), their histograms
    (``histogram``), and its scan joins the next step's ``split``.
    """
    single = grad.dim() == 1
    if single:
        grad, hess = grad[None], hess[None]
    C, n = grad.shape
    d = bins.shape[1]
    B = num_bins
    dev = bins.device
    max_nodes = 2 * max_leaves - 1
    depth_cap = max_depth if max_depth > 0 else max_leaves
    cls = torch.arange(C, device=dev)
    # fills, not copies from the host: the step loop never waits for the device
    neg_inf = torch.full((), float("-inf"), device=dev)

    def full(value, dtype):
        return torch.full((C, max_nodes), value, dtype=dtype, device=dev)

    ids = torch.arange(max_nodes, dtype=torch.int32, device=dev).expand(C, -1)
    tree = {
        "feature": full(0, torch.int32),
        "bin": full(0, torch.int32),
        "default_left": full(False, torch.bool),
        "is_leaf": full(True, torch.bool),
        "leaf_value": full(0.0, torch.float32),
        "base_weight": full(0.0, torch.float32),
        "gain": full(0.0, torch.float32),
        "sum_hess": full(0.0, torch.float32),
        "left": ids.clone(),
        "right": ids.clone(),
    }
    # per-leaf best-split candidate store
    cand = {
        "gain": full(float("-inf"), torch.float32),
        "feature": full(0, torch.int32),
        "bin": full(0, torch.int32),
        "default_left": full(False, torch.bool),
    }
    node_g = full(0.0, torch.float32)
    node_h = full(0.0, torch.float32)
    node_depth = full(0, torch.int32)
    node_of_row = torch.zeros((C, n), dtype=torch.int32, device=dev)

    shard, ranks = collectives.world(group)
    reduce_scatter = hist_comm == "reduce_scatter" and group is not None
    d_scan = padded_feature_width(d, ranks) // ranks if reduce_scatter else d
    overlap = group is not None and comm_overlap()
    feat_shard = collectives.world(feature_group)[0] if feature_group is not None else None
    _d_draw, pad_cols, local_cols = column_shard_helpers(feat_shard, d, n_feature_shards,
                                                         d_global)
    scan_params = dict(reg_lambda=reg_lambda, alpha=alpha, gamma=gamma,
                       min_child_weight=min_child_weight)

    def scan_slice(t):
        """A per-feature scan input -> this rank's slice (reduce_scatter)."""
        if not reduce_scatter or t is None:
            return t
        return shard_feature_slice(t, shard, d_scan, ranks)

    scan_cuts, scan_mono = scan_slice(num_cuts.to(dev)), scan_slice(monotone)

    def scan(G, H, mask=None):
        """Reduced [C, W, d_scan, B] histograms (and a [C, W or 1, d] mask
        at the padded global width) -> the split scan's dict of [C, W]."""
        W = G.shape[1]
        splits = merged_scan(
            G.reshape(C * W, d_scan, B), H.reshape(C * W, d_scan, B), scan_cuts,
            scan_slice(local_cols(mask)), scan_mono, scan_params, shard, group,
            reduce_scatter, feat_shard, feature_group, d)
        return {k: v.reshape(C, W) for k, v in splits.items()}

    def reduced_scan(G, H, mask):
        """Local [C, W, d, B] histograms -> their collective in node
        batches, each waited on before its batch's scan -> (split dict,
        reduced G, reduced H)."""
        pending = [(nsl, apply_hist_collective(G[:, nsl], H[:, nsl], group, hist_comm,
                                               async_op=True))
                   for nsl in overlap_node_batches(G.shape[1], overlap)]
        parts, Gs, Hs = [], [], []
        for nsl, p in pending:
            Gb, Hb = p.wait()
            m = mask[:, nsl] if mask is not None and mask.shape[1] > 1 else mask
            parts.append(scan(Gb, Hb, m))
            Gs.append(Gb)
            Hs.append(Hb)
        cat = (lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs, dim=1))
        return concat_node_splits(parts, dim=1), cat(Gs), cat(Hs)

    tree_mask = level_masks = node_masks = None
    if masks is not None:
        if masks.tree is not None:
            tree_mask = masks.tree[:, None, :].expand(C, -1, -1)
        if masks.level is not None:
            level_masks = masks.level.expand(C, -1, -1)
        node_masks = masks.node

    def scan_mask(depth, slots=None):
        """The mask of nodes at ``depth`` ([C], a class's own), in node
        ``slots`` -> [C, len(slots) or 1, d] at the padded global width, or
        None without sampling."""
        level = None
        if level_masks is not None:
            level = level_masks[cls, torch.clamp(depth, max=depth_cap).long()][:, None, :]
        node = None
        if node_masks is not None and slots is not None:
            node = node_masks[:, slots].expand(C, -1, -1)
        return pad_cols(combine_masks(tree_mask, level, node))

    # interaction constraints: the sets alive at each slot, [C, max_nodes, S]
    alive = sets = None
    if interaction_sets is not None:
        sets = interaction_sets.to(dev)
        alive = torch.zeros((C, max_nodes, sets.shape[0]), dtype=torch.bool, device=dev)
        alive[:, 0] = True

    def allowed(alive_rows):
        """[C, S] alive sets -> the [C, 1, d] mask of their features."""
        return ((alive_rows.float() @ sets.float()) > 0).float()[:, None, :]

    def store(slot, splits, k, gain):
        cand["gain"][:, slot] = gain
        for key in ("feature", "bin", "default_left"):
            cand[key][:, slot] = splits[key][:, k]
        node_g[:, slot] = splits["g_total"][:, k]
        node_h[:, slot] = splits["h_total"][:, k]

    # the gate reads the full feature width under both lowerings
    subtract = _subtraction_enabled(max_leaves, d, B)
    G, H = level_histogram(bins, grad, hess, node_of_row, 1, B)
    if stamp is not None:
        stamp(HISTOGRAM)
    root_mask = scan_mask(node_depth[:, 0])
    if alive is not None:
        root_mask = combine_masks(root_mask, allowed(alive[:, 0]))
    root, G, H = reduced_scan(G, H, root_mask)
    if subtract:
        # the reduced histograms of every slot (this rank's feature slice
        # under reduce_scatter)
        hist_G = torch.zeros((C, max_nodes, d_scan, B), dtype=torch.float32, device=dev)
        hist_H = torch.zeros_like(hist_G)
        hist_G[:, 0], hist_H[:, 0] = G[:, 0], H[:, 0]
    store(0, root, 0, root["gain"][:, 0])

    for t in range(max_leaves - 1):
        id_a, id_b = 2 * t + 1, 2 * t + 2
        gains = torch.where(tree["is_leaf"], cand["gain"], neg_inf)
        leaf = torch.argmax(gains, dim=1)  # the first of equal gains
        best = gains[cls, leaf]
        can = best > MIN_SPLIT_LOSS
        f, b, dl = (cand[k][cls, leaf] for k in ("feature", "bin", "default_left"))

        # mark the split (nothing changes where the step cannot split)
        for key, value in (("feature", f), ("bin", b), ("default_left", dl),
                           ("is_leaf", False), ("gain", best), ("left", id_a),
                           ("right", id_b)):
            tree[key][cls, leaf] = torch.where(can, value, tree[key][cls, leaf])
        cand["gain"].index_put_((cls, leaf), neg_inf)  # picked: never again
        if stamp is not None:
            stamp(SPLIT)

        # route the leaf's rows to the fresh children
        go_right = route_rows(bins, f[:, None].expand(C, n), b[:, None], dl[:, None], B,
                              feature_group, feat_shard)
        in_leaf = (node_of_row == leaf[:, None].int()) & can[:, None]
        node_of_row = torch.where(in_leaf, id_a + go_right.int(), node_of_row)  # id_b = id_a + 1

        depth = node_depth[cls, leaf] + 1
        node_depth[:, id_a] = depth
        node_depth[:, id_b] = depth
        mask = scan_mask(depth, slice(id_a, id_b + 1))
        if alive is not None:
            # inert where the step cannot split: the children's gains are
            # -inf below
            child_alive = alive[cls, leaf] & sets[:, f.long()].T
            alive[:, id_a], alive[:, id_b] = child_alive, child_alive
            mask = combine_masks(mask, allowed(child_alive))
        # the fresh slots hold no row unless the step split
        if subtract:
            # histogram only the left child; right = the reduced cached
            # parent - the reduced left, zero when the step could not split
            left_local = torch.where(node_of_row == id_a, 0, -1).int()
            if stamp is not None:
                stamp(PARTITION)
            Ga, Ha = apply_hist_collective(
                *level_histogram(bins, grad, hess, left_local, 1, B), group, hist_comm)
            keep = can[:, None, None]
            Gb = torch.where(keep, hist_G[cls, leaf] - Ga[:, 0], 0.0)
            Hb = torch.where(keep, hist_H[cls, leaf] - Ha[:, 0], 0.0)
            hist_G[:, id_a], hist_G[:, id_b] = Ga[:, 0], Gb
            hist_H[:, id_a], hist_H[:, id_b] = Ha[:, 0], Hb
            G, H = torch.stack([Ga[:, 0], Gb], dim=1), torch.stack([Ha[:, 0], Hb], dim=1)
            if stamp is not None:
                stamp(HISTOGRAM)
            splits = scan(G, H, mask)
        else:
            child_local = torch.where(
                node_of_row == id_a, 0, torch.where(node_of_row == id_b, 1, -1)).int()
            if stamp is not None:
                stamp(PARTITION)
            G, H = level_histogram(bins, grad, hess, child_local, 2, B)
            if stamp is not None:
                stamp(HISTOGRAM)
            splits, _G, _H = reduced_scan(G, H, mask)
        # children at the depth cap never split; those of a step that could
        # not split hold no rows and are never picked
        open_ = (can & (depth < depth_cap))[:, None]
        child_gain = torch.where(open_, splits["gain"], neg_inf)
        store(id_a, splits, 0, child_gain[:, 0])
        store(id_b, splits, 1, child_gain[:, 1])

    weight = leaf_weight(node_g, node_h, reg_lambda=reg_lambda, alpha=alpha,
                         max_delta_step=max_delta_step)
    tree["base_weight"] = weight
    tree["sum_hess"] = node_h
    tree["leaf_value"] = torch.where(tree["is_leaf"], eta * weight, 0.0)
    if stamp is not None:
        stamp(SPLIT)
    row_out = torch.gather(tree["leaf_value"], 1, node_of_row.long())
    if stamp is not None:
        stamp(PARTITION)
    if single:
        return {k: v[0] for k, v in tree.items()}, row_out[0]
    return tree, row_out
