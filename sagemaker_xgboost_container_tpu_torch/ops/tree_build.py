"""Level-wise tree growth on one device, as an eager loop over levels.

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

Constraints, as in the JAX package: ``monotone`` orders the two children of
every split on a constrained feature (``ops/split``); ``interaction_sets``
keep, per node, the constraint sets still alive (all at the root; a split on
f keeps those that hold f), and a node may split only on a feature of an
alive set.
"""

import numpy as np
import torch

from .histogram import level_histogram, node_totals, subtraction_enabled
from .split import combine_masks, find_best_splits, leaf_weight

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
):
    """Grow one tree on grad, hess [n], or C trees on [C, n] (one per
    class, sharing the bins). Returns (tree tensors dict, row_out f32 [n] or
    [C, n]).

    ``masks``: optional ``ColumnMasks`` with ``level`` [1 or C, max_depth,
    d] and ``node`` [1 or C, 2**max_depth - 1, d] (one row per node slot of
    the levels that split). ``monotone``: optional i32 [d] in {-1, 0, 1}.
    ``interaction_sets``: optional bool [S, d], one row a constraint set.

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

    subtract = _subtraction_enabled(max_depth, d, num_bins)
    G_cache = H_cache = None      # previous level's [C, W/2, d, B] histograms
    parent_leaf = None            # previous level's becomes_leaf [C, W/2]

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
            g_tot, h_tot = node_totals(grad, hess, node_local, width)
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
            # one is parent - left. Parents that leafed routed no rows to
            # their children, so their pair contribution is zeroed.
            is_left = (node_local % 2) == 0
            left_local = torch.where(at_level & is_left, node_local // 2, minus_one)
            Gl, Hl = level_histogram(bins, grad, hess, left_local, width // 2, num_bins)
            keep = ~parent_leaf[:, :, None, None]
            Gr = torch.where(keep, G_cache, 0.0) - Gl
            Hr = torch.where(keep, H_cache, 0.0) - Hl
            G = torch.stack([Gl, Gr], dim=2).reshape(C, width, d, num_bins)
            H = torch.stack([Hl, Hr], dim=2).reshape(C, width, d, num_bins)
        else:
            G, H = level_histogram(bins, grad, hess, node_local, width, num_bins)
        if subtract:
            G_cache, H_cache = G, H

        feature_mask = None
        if masks is not None:
            feature_mask = combine_masks(
                None if masks.tree is None else masks.tree[:, None, :],
                None if masks.level is None else masks.level[:, level, None, :],
                None if masks.node is None else masks.node[:, sl],
            )
        if alive is not None:
            # [C, W, S] @ [S, d]: a feature of some alive set
            allowed = ((alive.float() @ sets_f) > 0).float()
            feature_mask = combine_masks(feature_mask, allowed)
        if feature_mask is not None:
            feature_mask = feature_mask.expand(C, -1, -1)
        # the split scan works per node: the classes' nodes side by side
        splits = find_best_splits(
            G.reshape(C * width, d, num_bins), H.reshape(C * width, d, num_bins),
            num_cuts,
            reg_lambda=reg_lambda, alpha=alpha, gamma=gamma,
            min_child_weight=min_child_weight, feature_mask=feature_mask,
            monotone=monotone,
        )
        splits = {k: v.reshape(C, width) for k, v in splits.items()}
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
        row_bin = row_bin_lookup(bins, per_row(splits["feature"]))
        is_missing = row_bin == (num_bins - 1)
        go_right = torch.where(
            is_missing,
            ~per_row(splits["default_left"]),
            row_bin > per_row(splits["bin"]),
        )
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
