"""Level-wise tree growth on one device, as an eager loop over levels.

A tree with ``max_depth`` grows into a padded full-binary layout of
``2**(max_depth+1) - 1`` node slots (children of i at 2i+1 / 2i+2). Per
level: histogram -> split scan -> finalize leaves -> route rows to children.
Rows carry their node id; finalized rows hold -1 and accumulate their leaf
value into ``row_out``, so the booster updates margins without
re-predicting the train set.
"""

import numpy as np
import torch

from .histogram import level_histogram, node_totals, subtraction_enabled
from .split import find_best_splits, leaf_weight

MIN_SPLIT_LOSS = 1e-6  # xgboost kRtEps


def row_bin_lookup(bins, feat_idx):
    """Per-row bin of a per-row feature, ``bins[i, feat_idx[i]]``, as i32."""
    if bins.dtype == torch.uint16:
        picked = torch.gather(bins.view(torch.int16), 1, feat_idx.long()[:, None])
        return (picked[:, 0].int() & 0xFFFF)
    return torch.gather(bins, 1, feat_idx.long()[:, None])[:, 0].int()


def max_nodes_for_depth(max_depth):
    return 2 ** (max_depth + 1) - 1


def _subtraction_enabled(max_depth, d, num_bins):
    """Sibling subtraction: build only left children, derive right ones as
    parent - left. Needs the previous level's histograms cached, gated by the
    shared memory cap."""
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
):
    """Grow one tree. Returns (tree tensors dict, row_out f32 [n]).

    Tree tensors (length ``max_nodes_for_depth(max_depth)``): feature, bin
    (i32), default_left (bool), is_leaf (bool), leaf_value (f32, eta already
    applied), base_weight (f32, pre-eta), gain (f32), sum_hess (f32), left,
    right (i32; leaves self-loop).
    """
    n, d = bins.shape
    dev = bins.device
    max_nodes = max_nodes_for_depth(max_depth)
    tree = {
        "feature": torch.zeros(max_nodes, dtype=torch.int32, device=dev),
        "bin": torch.zeros(max_nodes, dtype=torch.int32, device=dev),
        "default_left": torch.zeros(max_nodes, dtype=torch.bool, device=dev),
        "is_leaf": torch.zeros(max_nodes, dtype=torch.bool, device=dev),
        "leaf_value": torch.zeros(max_nodes, dtype=torch.float32, device=dev),
        "base_weight": torch.zeros(max_nodes, dtype=torch.float32, device=dev),
        "gain": torch.zeros(max_nodes, dtype=torch.float32, device=dev),
        "sum_hess": torch.zeros(max_nodes, dtype=torch.float32, device=dev),
    }
    node_of_row = torch.zeros(n, dtype=torch.int32, device=dev)
    row_out = torch.zeros(n, dtype=torch.float32, device=dev)
    minus_one = torch.tensor(-1, dtype=torch.int32, device=dev)

    subtract = _subtraction_enabled(max_depth, d, num_bins)
    G_cache = H_cache = None      # previous level's [W/2, d, B] histograms
    parent_leaf = None            # previous level's becomes_leaf [W/2]

    for level in range(max_depth + 1):
        first = 2**level - 1
        width = 2**level
        node_local = node_of_row - first  # negative for finalized rows
        at_level = node_local >= 0
        local_safe = torch.clamp(node_local, 0, width - 1).long()
        sl = slice(first, first + width)

        if level == max_depth:
            # last level: every surviving node becomes a leaf, and leaf
            # weights need only per-node totals, not a [W, d, B] histogram
            g_tot, h_tot = node_totals(grad, hess, node_local, width)
            weight = leaf_weight(
                g_tot, h_tot,
                reg_lambda=reg_lambda, alpha=alpha, max_delta_step=max_delta_step,
            )
            tree["is_leaf"][sl] = True
            tree["leaf_value"][sl] = eta * weight
            tree["base_weight"][sl] = weight
            tree["sum_hess"][sl] = h_tot
            row_out = torch.where(at_level, eta * weight[local_safe], row_out)
            break

        if subtract and level > 0:
            # histogram only the LEFT child of each sibling pair; the right
            # one is parent - left. Parents that leafed routed no rows to
            # their children, so their pair contribution is zeroed.
            is_left = (node_local % 2) == 0
            left_local = torch.where(at_level & is_left, node_local // 2, minus_one)
            Gl, Hl = level_histogram(bins, grad, hess, left_local, width // 2, num_bins)
            keep = ~parent_leaf[:, None, None]
            Gr = torch.where(keep, G_cache, 0.0) - Gl
            Hr = torch.where(keep, H_cache, 0.0) - Hl
            G = torch.stack([Gl, Gr], dim=1).reshape(width, d, num_bins)
            H = torch.stack([Hl, Hr], dim=1).reshape(width, d, num_bins)
        else:
            G, H = level_histogram(bins, grad, hess, node_local, width, num_bins)
        if subtract:
            G_cache, H_cache = G, H

        splits = find_best_splits(
            G, H, num_cuts,
            reg_lambda=reg_lambda, alpha=alpha, gamma=gamma,
            min_child_weight=min_child_weight,
        )
        weight = leaf_weight(
            splits["g_total"], splits["h_total"],
            reg_lambda=reg_lambda, alpha=alpha, max_delta_step=max_delta_step,
        )
        can_split = splits["gain"] > MIN_SPLIT_LOSS
        becomes_leaf = ~can_split
        parent_leaf = becomes_leaf

        tree["feature"][sl] = splits["feature"]
        tree["bin"][sl] = splits["bin"]
        tree["default_left"][sl] = splits["default_left"]
        tree["is_leaf"][sl] = becomes_leaf
        tree["leaf_value"][sl] = torch.where(becomes_leaf, eta * weight, 0.0)
        tree["base_weight"][sl] = weight
        tree["gain"][sl] = torch.where(can_split, splits["gain"], 0.0)
        tree["sum_hess"][sl] = splits["h_total"]

        # --- route rows ----------------------------------------------------
        row_leafed = at_level & becomes_leaf[local_safe]
        row_out = torch.where(row_leafed, eta * weight[local_safe], row_out)
        row_bin = row_bin_lookup(bins, splits["feature"][local_safe])
        is_missing = row_bin == (num_bins - 1)
        go_right = torch.where(
            is_missing,
            ~splits["default_left"][local_safe],
            row_bin > splits["bin"][local_safe],
        )
        child = node_of_row * 2 + 1 + go_right.int()
        node_of_row = torch.where(
            row_leafed, minus_one, torch.where(at_level, child, node_of_row)
        )

    # explicit child indices (leaves self-loop)
    ids = torch.arange(max_nodes, dtype=torch.int32, device=dev)
    tree["left"] = torch.where(tree["is_leaf"], ids, 2 * ids + 1)
    tree["right"] = torch.where(tree["is_leaf"], ids, 2 * ids + 2)
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
    """Tree dict -> one f32 [10, max_nodes] tensor (one device-to-host copy)."""
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
    """Apply one trained tree to binned rows -> margins [n].

    ``max_depth`` rounds of routing (leaves self-loop, so rows that reached a
    leaf stay put). Used for eval-set margins during training: eval sets are
    binned with the training cuts, so bin comparison == float comparison.
    """
    node = torch.zeros(bins.shape[0], dtype=torch.long, device=bins.device)
    for _ in range(max_depth):
        row_bin = row_bin_lookup(bins, tree["feature"][node])
        is_missing = row_bin == (num_bins - 1)
        go_right = torch.where(
            is_missing, ~tree["default_left"][node], row_bin > tree["bin"][node]
        )
        child = torch.where(go_right, tree["right"][node], tree["left"][node]).long()
        node = torch.where(tree["is_leaf"][node], node, child)
    return tree["leaf_value"][node]
