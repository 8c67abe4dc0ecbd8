"""Level-wise tree growth, as an eager loop over levels.

A tree with ``max_depth`` grows into a padded full-binary layout of
``2**(max_depth+1) - 1`` node slots (children of i at 2i+1 / 2i+2). Per
level: histogram -> split scan -> finalize leaves -> route rows to children.
Rows carry their node id; finalized rows hold -1 and accumulate their leaf
value into ``row_out``, so the booster updates margins without
re-predicting the train set.

A multiclass round grows its C trees together, on ``[C, n]`` gradients:
every per-row and per-node tensor gets a leading class axis, each level's
histogram is one call over all classes (the JAX package's ``jax.vmap`` of
the builder, written out), and the split scan sees the ``[C*W, d, B]``
histograms as C*W nodes. The class axis need not hold classes: fold-parallel
cross-validation puts its folds there (``models/cv_parallel``).

Column sampling arrives as ``ColumnMasks`` (``ops/split``), drawn by the
caller (``models/sampling``): level l scans with the tree's column set times
row l of the level masks times the node masks of its node slots, as the
JAX package's ``build_tree`` applies its draws.

Data-parallel training (``group``): each rank grows the tree on its own
rows, and every level's histograms are reduced over the process group
before the split scan, so every rank commits the same tree (the JAX
package's ``axis_name`` path of ``build_tree``).

The feature axis (``feature_group``, the JAX package's ``feature_axis_name``
path): ``bins`` holds only this feature shard's ``d_local`` columns of the
padded global width. The scan runs on the local columns; the winners merge
over the feature group by max gain, ties going to the lowest global feature
id (``combine_splits_across_shards``), so the emitted feature ids are
global; the node totals are feature shard 0's, broadcast before the scan
(``share_node_totals``); and only the shard that owns a node's split
feature can route its rows, so each level sums the owners' decisions over
the feature group (``route_rows``). Under ``reduce_scatter`` the two
compose: the data group scatters the local columns again, and the winners
merge over the data group first, then over the feature group.

Constraints, as in the JAX package: ``monotone`` orders the two children of
every split on a constrained feature (``ops/split``); ``interaction_sets``
keep, per node, the constraint sets still alive (all at the root; a split on
f keeps those that hold f), and a node may split only on a feature of an
alive set.
"""

import numpy as np
import torch

from ..parallel import collectives
from .histogram import (
    apply_hist_collective,
    comm_overlap,
    level_histogram,
    node_totals,
    overlap_node_batches,
    padded_feature_width,
    reduce_node_totals,
    subtraction_enabled,
)
from .split import (
    broadcast_node_totals,
    column_shard_helpers,
    combine_masks,
    combine_splits_across_shards,
    concat_node_splits,
    find_best_splits,
    leaf_weight,
    shard_feature_slice,
    share_node_totals,
)

MIN_SPLIT_LOSS = 1e-6  # xgboost kRtEps


def row_bin_lookup(bins, feat_idx):
    """Per-row bin of a per-row feature as i32: ``bins[i, feat_idx[i]]`` for
    ``feat_idx`` [n], ``bins[i, feat_idx[c, i]]`` for [C, n]."""
    index = feat_idx.long()[:, None] if feat_idx.dim() == 1 else feat_idx.long().T
    if bins.dtype == torch.uint16:
        picked = torch.gather(bins.view(torch.int16), 1, index).int() & 0xFFFF
    else:
        picked = torch.gather(bins, 1, index).int()
    return picked[:, 0] if feat_idx.dim() == 1 else picked.T


def route_rows(bins, feature, split_bin, default_left, num_bins, feature_group=None,
               feature_shard=0):
    """Each row's routing decision (True: the right child) for per-row
    global split features ``feature`` [n] or [C, n] (``split_bin`` and
    ``default_left`` broadcast against it). Without a feature axis the row's
    own bin decides. Over a feature group only the shard that owns the
    feature holds its column: it decides, the other shards add zeros, and
    the decisions are summed over the group (one uint8 all-reduce, the JAX
    package's int32 ``psum``; at most one owner adds a 1)."""
    d = bins.shape[1]
    if feature_group is None:
        row_bin = row_bin_lookup(bins, feature)
        return torch.where(row_bin == num_bins - 1, ~default_left, row_bin > split_bin)
    lo = feature_shard * d
    owner = (feature >= lo) & (feature < lo + d)
    row_bin = row_bin_lookup(bins, torch.clamp(feature - lo, 0, d - 1))
    decision = torch.where(row_bin == num_bins - 1, ~default_left, row_bin > split_bin)
    votes = (decision & owner).to(torch.uint8)
    return collectives.all_reduce(votes, feature_group, kind="route") > 0


def merged_scan(G, H, num_cuts, mask, monotone, scan_params, shard, group, reduce_scatter,
                feature_shard, feature_group, d_local):
    """The split scan of reduced [N, d_scan, B] histograms with the merges
    of both axes -> the split dict of [N]: under ``reduce_scatter`` the
    totals broadcast from the data group's shard 0 and the winners merge
    over the data group (feature ids then index the ``d_local`` columns of
    this feature shard); over a feature group the totals are feature shard
    0's and the winners merge over the feature group, with global feature
    ids. Shared by both builders."""
    d_scan = G.shape[1]
    totals = broadcast_node_totals(G, H, shard, group) if reduce_scatter else None
    if feature_group is not None:
        if totals is None:
            totals = (G[:, 0, :].sum(dim=-1), H[:, 0, :].sum(dim=-1))
        totals = share_node_totals(*totals, feature_shard, feature_group)
    splits = find_best_splits(G, H, num_cuts, feature_mask=mask, monotone=monotone,
                              totals=totals, **scan_params)
    if reduce_scatter:
        splits = combine_splits_across_shards(splits, shard, d_scan, group)
    if feature_group is not None:
        splits = combine_splits_across_shards(splits, feature_shard, d_local, feature_group)
    return splits


def max_nodes_for_depth(max_depth):
    return 2 ** (max_depth + 1) - 1


def _subtraction_enabled(max_depth, d, num_bins):
    """Sibling subtraction: build only left children, derive right ones as
    parent - left. Needs the previous level's histograms cached, gated by the
    shared memory cap on one class's cache, as the JAX package gates each
    class of its vmapped builder."""
    if max_depth < 2:
        return False
    return subtraction_enabled(2 * (2 ** (max_depth - 1)) * d * num_bins * 4)


def build_tree(
    bins,
    grad,
    hess,
    num_cuts,
    max_depth,
    num_bins,
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
):
    """Grow one tree on grad, hess [n], or C trees on [C, n] (one per
    class, sharing the bins). Returns (tree tensors dict, row_out f32 [n] or
    [C, n]).

    ``masks``: optional ``ColumnMasks`` with ``level`` [1 or C, max_depth,
    d] and ``node`` [1 or C, 2**max_depth - 1, d] (one row per node slot of
    the levels that split). ``monotone``: optional i32 [d] in {-1, 0, 1}.
    ``interaction_sets``: optional bool [S, d], one row a constraint set.

    ``feature_group``: the feature axis (None: every column on this rank).
    ``bins`` [n, d_local], ``num_cuts`` and ``monotone`` are then this
    feature shard's slice of the padded global width ``d_local *
    n_feature_shards``; ``masks`` stay at the real global width
    ``d_global`` and ``interaction_sets`` at the padded global width, and
    each level's masks are sliced to the local columns
    (``column_shard_helpers``). The tree's feature ids are global.

    ``group``: the process group of data-parallel training (None: one
    rank). Each rank passes its own rows; every level's histograms are
    reduced over the group between the local kernel launch and the split
    scan (``apply_hist_collective``), so every rank scans the same sums and
    grows the same tree. With sibling subtraction the collective runs on the
    left children, and the right ones are the reduced parent minus the
    reduced left. The last level's node totals are reduced too. A level's
    collective is issued in two node batches (``GRAFT_HIST_OVERLAP``), each
    waited on before its batch's scan. ``hist_comm`` ``reduce_scatter``
    scans only this rank's feature slice and merges the winners across
    ranks (``combine_splits_across_shards``); its trees equal the ``psum``
    lowering's bit for bit.

    Tree tensors (length ``max_nodes_for_depth(max_depth)``, or [C, that]):
    feature, bin (i32), default_left (bool), is_leaf (bool), leaf_value
    (f32, eta already applied), base_weight (f32, pre-eta), gain (f32),
    sum_hess (f32), left, right (i32; leaves self-loop).
    """
    single = grad.dim() == 1
    if single:
        grad, hess = grad[None], hess[None]
    C, n = grad.shape
    d = bins.shape[1]
    dev = bins.device
    max_nodes = max_nodes_for_depth(max_depth)
    shard, ranks = collectives.world(group)
    reduce_scatter = hist_comm == "reduce_scatter" and group is not None
    d_scan = padded_feature_width(d, ranks) // ranks if reduce_scatter else d
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

    def zeros(dtype):
        return torch.zeros((C, max_nodes), dtype=dtype, device=dev)

    tree = {
        "feature": zeros(torch.int32),
        "bin": zeros(torch.int32),
        "default_left": zeros(torch.bool),
        "is_leaf": zeros(torch.bool),
        "leaf_value": zeros(torch.float32),
        "base_weight": zeros(torch.float32),
        "gain": zeros(torch.float32),
        "sum_hess": zeros(torch.float32),
    }
    node_of_row = torch.zeros((C, n), dtype=torch.int32, device=dev)
    row_out = torch.zeros((C, n), dtype=torch.float32, device=dev)
    minus_one = torch.full((), -1, dtype=torch.int32, device=dev)  # no host copy

    # interaction constraints: the sets still alive at each node, [C, W, S]
    alive = sets_f = None
    if interaction_sets is not None:
        sets_f = interaction_sets.to(dev).float()
        alive = torch.ones((C, 1, interaction_sets.shape[0]), dtype=torch.bool, device=dev)

    # the gate reads the full feature width under both lowerings, so that
    # psum and reduce_scatter take the same build path
    subtract = _subtraction_enabled(max_depth, d, num_bins)
    overlap = group is not None and comm_overlap()
    G_cache = H_cache = None      # previous level's reduced [C, W/2, d_scan, B]
    parent_leaf = None            # previous level's becomes_leaf [C, W/2]
    scan_cuts = scan_slice(num_cuts.to(dev))
    scan_mono = scan_slice(monotone)

    for level in range(max_depth + 1):
        first = 2**level - 1
        width = 2**level
        node_local = node_of_row - first  # negative for finalized rows
        at_level = node_local >= 0
        local_safe = torch.clamp(node_local, 0, width - 1).long()
        sl = slice(first, first + width)

        def per_row(per_node):
            """[C, width] per-node values -> each row's node's, [C, n]."""
            return torch.gather(per_node, 1, local_safe)

        if level == max_depth:
            # last level: every surviving node becomes a leaf, and leaf
            # weights need only per-node totals, not a [W, d, B] histogram
            g_tot, h_tot = reduce_node_totals(
                *node_totals(grad, hess, node_local, width), group)
            weight = leaf_weight(
                g_tot, h_tot,
                reg_lambda=reg_lambda, alpha=alpha, max_delta_step=max_delta_step,
            )
            tree["is_leaf"][:, sl] = True
            tree["leaf_value"][:, sl] = eta * weight
            tree["base_weight"][:, sl] = weight
            tree["sum_hess"][:, sl] = h_tot
            row_out = torch.where(at_level, eta * per_row(weight), row_out)
            break

        if subtract and level > 0:
            # histogram only the LEFT child of each sibling pair; the right
            # one is the reduced parent - the reduced left. Parents that
            # leafed routed no rows to their children, so their pair
            # contribution is zeroed. One kernel launch for the level, its
            # collective issued per node batch of the parents.
            is_left = (node_local % 2) == 0
            left_local = torch.where(at_level & is_left, node_local // 2, minus_one)
            Gl_loc, Hl_loc = level_histogram(bins, grad, hess, left_local, width // 2,
                                             num_bins)
            keep = ~parent_leaf[:, :, None, None]
            pending = [(psl, apply_hist_collective(Gl_loc[:, psl], Hl_loc[:, psl], group,
                                                   hist_comm, async_op=True))
                       for psl in overlap_node_batches(width // 2, overlap)]

            def batch(psl, reduced):
                Gl, Hl = reduced
                Gr = torch.where(keep[:, psl], G_cache[:, psl], 0.0) - Gl
                Hr = torch.where(keep[:, psl], H_cache[:, psl], 0.0) - Hl
                w = 2 * Gl.shape[1]
                return (slice(2 * psl.start, 2 * psl.stop),
                        torch.stack([Gl, Gr], dim=2).reshape(C, w, d_scan, num_bins),
                        torch.stack([Hl, Hr], dim=2).reshape(C, w, d_scan, num_bins))
        else:
            G_loc, H_loc = level_histogram(bins, grad, hess, node_local, width, num_bins)
            pending = [(nsl, apply_hist_collective(G_loc[:, nsl], H_loc[:, nsl], group,
                                                   hist_comm, async_op=True))
                       for nsl in overlap_node_batches(width, overlap)]

            def batch(nsl, reduced):
                return (nsl,) + tuple(reduced)

        # the masks at the global width (drawn over the real columns, then
        # padded), sliced to this feature shard's columns
        feature_mask = None
        if masks is not None:
            feature_mask = pad_cols(combine_masks(
                None if masks.tree is None else masks.tree[:, None, :],
                None if masks.level is None else masks.level[:, level, None, :],
                None if masks.node is None else masks.node[:, sl],
            ))
        if alive is not None:
            # [C, W, S] @ [S, d]: a feature of some alive set
            allowed = ((alive.float() @ sets_f) > 0).float()
            feature_mask = combine_masks(feature_mask, allowed)
        if feature_mask is not None:
            feature_mask = scan_slice(local_cols(feature_mask).expand(C, -1, -1))

        def scan(nsl, Gb, Hb):
            """Gain-scan one node batch -> the split dict of [C, w]."""
            w = Gb.shape[1]
            mask = feature_mask
            if mask is not None and mask.shape[1] > 1:
                mask = mask[:, nsl]
            splits = merged_scan(
                Gb.reshape(C * w, d_scan, num_bins), Hb.reshape(C * w, d_scan, num_bins),
                scan_cuts, mask, scan_mono, scan_params, shard, group, reduce_scatter,
                feat_shard, feature_group, d)
            return {k: v.reshape(C, w) for k, v in splits.items()}

        # the split scan works per node: the classes' nodes side by side
        parts, G_parts, H_parts = [], [], []
        for nsl, p in pending:
            nsl, Gb, Hb = batch(nsl, p.wait())
            parts.append(scan(nsl, Gb, Hb))
            G_parts.append(Gb)
            H_parts.append(Hb)
        splits = concat_node_splits(parts, dim=1)
        if subtract:
            G_cache = G_parts[0] if len(G_parts) == 1 else torch.cat(G_parts, dim=1)
            H_cache = H_parts[0] if len(H_parts) == 1 else torch.cat(H_parts, dim=1)
        weight = leaf_weight(
            splits["g_total"], splits["h_total"],
            reg_lambda=reg_lambda, alpha=alpha, max_delta_step=max_delta_step,
        )
        can_split = splits["gain"] > MIN_SPLIT_LOSS
        becomes_leaf = ~can_split
        parent_leaf = becomes_leaf

        tree["feature"][:, sl] = splits["feature"]
        tree["bin"][:, sl] = splits["bin"]
        tree["default_left"][:, sl] = splits["default_left"]
        tree["is_leaf"][:, sl] = becomes_leaf
        tree["leaf_value"][:, sl] = torch.where(becomes_leaf, eta * weight, 0.0)
        tree["base_weight"][:, sl] = weight
        tree["gain"][:, sl] = torch.where(can_split, splits["gain"], 0.0)
        tree["sum_hess"][:, sl] = splits["h_total"]

        # --- route rows ----------------------------------------------------
        row_leafed = at_level & per_row(becomes_leaf)
        row_out = torch.where(row_leafed, eta * per_row(weight), row_out)
        go_right = route_rows(bins, per_row(splits["feature"]), per_row(splits["bin"]),
                              per_row(splits["default_left"]), num_bins, feature_group,
                              feat_shard)
        child = node_of_row * 2 + 1 + go_right.int()
        node_of_row = torch.where(
            row_leafed, minus_one, torch.where(at_level, child, node_of_row)
        )
        if alive is not None:
            # both children keep the sets that hold their parent's feature
            held = interaction_sets.to(dev)[:, splits["feature"].long()].permute(1, 2, 0)
            alive = (alive & held).repeat_interleave(2, dim=1)

    # explicit child indices (leaves self-loop)
    ids = torch.arange(max_nodes, dtype=torch.int32, device=dev)
    tree["left"] = torch.where(tree["is_leaf"], ids, 2 * ids + 1)
    tree["right"] = torch.where(tree["is_leaf"], ids, 2 * ids + 2)
    if single:
        return {k: v[0] for k, v in tree.items()}, row_out[0]
    return tree, row_out


_TREE_FIELDS = (
    "feature",
    "bin",
    "default_left",
    "is_leaf",
    "leaf_value",
    "base_weight",
    "gain",
    "sum_hess",
    "left",
    "right",
)


def pack_tree(tree):
    """Tree dict -> one f32 [10, max_nodes] (or [10, C, max_nodes]) tensor:
    one device-to-host copy."""
    return torch.stack([tree[k].float() for k in _TREE_FIELDS])


def tree_from_packed(packed):
    """Packed tensor -> tree dict of tensors on the same device."""
    return {
        "feature": packed[0].int(),
        "bin": packed[1].int(),
        "default_left": packed[2] > 0.5,
        "is_leaf": packed[3] > 0.5,
        "leaf_value": packed[4],
        "base_weight": packed[5],
        "gain": packed[6],
        "sum_hess": packed[7],
        "left": packed[8].int(),
        "right": packed[9].int(),
    }


def unpack_tree(packed):
    """Packed array (numpy or tensor) -> host tree dict with numpy dtypes."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    out = {}
    for i, key in enumerate(_TREE_FIELDS):
        arr = np.asarray(packed[i])
        if key in ("feature", "bin", "left", "right"):
            out[key] = arr.astype(np.int32)
        elif key in ("default_left", "is_leaf"):
            out[key] = arr.astype(bool)
        else:
            out[key] = arr.astype(np.float32)
    return out


def predict_binned(tree, bins, max_depth, num_bins):
    """Apply one trained tree (tensors [max_nodes]) to binned rows ->
    margins [n], or C trees ([C, max_nodes]) -> [C, n].

    ``max_depth`` rounds of routing (leaves self-loop, so rows that reached a
    leaf stay put). Used for eval-set margins during training: eval sets are
    binned with the training cuts, so bin comparison == float comparison.
    """
    single = tree["feature"].dim() == 1
    trees = {k: v[None] if single else v for k, v in tree.items()}
    C = trees["feature"].shape[0]
    node = torch.zeros((C, bins.shape[0]), dtype=torch.long, device=bins.device)

    def at_node(key):
        return torch.gather(trees[key], 1, node)

    for _ in range(max_depth):
        row_bin = row_bin_lookup(bins, at_node("feature"))
        is_missing = row_bin == (num_bins - 1)
        go_right = torch.where(
            is_missing, ~at_node("default_left"), row_bin > at_node("bin")
        )
        child = torch.where(go_right, at_node("right"), at_node("left")).long()
        node = torch.where(at_node("is_leaf"), node, child)
    out = at_node("leaf_value")
    return out[0] if single else out
