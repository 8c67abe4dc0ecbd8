"""Forest inference: traversal over stacked per-tree node arrays.

The forest is laid out as [T, N] node arrays (``Forest._stack``); traversal
is ``depth`` rounds of vectorized gather/compare over [rows x trees]. The
same rules run as torch ops on the forest's device (``forest_predict_margin``)
and as numpy on the host for tiny payloads (``host_predict_margin``).

Rules (xgboost semantics): NaN-missing follows ``default_left``; a
numerical node sends a row right when ``v >= threshold``; a categorical node
(the stacked forest carries ``cat_split`` [T, N] and ``cat_mask`` [T, N, W],
BYO xgboost models) by ``categorical_go_right``; leaves self-loop via
left/right == own index.
"""

import numpy as np
import torch


def categorical_go_right(v, miss, dfl, cat_mask, t_idx, node):
    """The categorical routing rule (xgboost common::Decision), one helper
    for the torch and the numpy traversal alike (both namespaces share the
    operators, ``where``, ``clip`` and ``nan_to_num`` used here).

    v: the rows' values at their nodes [n, T] (f32), miss = isnan(v), dfl
    the nodes' default_left; cat_mask [T, N, W] holds each node's
    right-branch category set as 32-bit words (int32 with the bits of the
    xgboost u32 words). A category in the set goes right; NaN follows
    default_left; an invalid value (v < 0 or v >= 32 W, checked on the
    float, so -0.5 is invalid) goes left. The float is clipped before its
    integer cast: a cast of inf, NaN or values >= 2^31 is undefined on CUDA.
    """
    xp = np if isinstance(v, np.ndarray) else torch
    max_cat = cat_mask.shape[2] * 32
    invalid = (v < 0) | (v >= max_cat)
    clipped = xp.nan_to_num(v, nan=-1.0).clip(-1.0, float(max_cat))
    cat = clipped.astype(np.int64) if xp is np else clipped.to(torch.int64)
    cat = cat.clip(0, max_cat - 1)
    word = cat_mask[t_idx, node, cat >> 5]
    in_set = ((word >> (cat & 31)) & 1) == 1
    return xp.where(miss, ~dfl, in_set & ~invalid)


def forest_leaf_nodes(stacked, x):
    """x: f32 tensor [n, d] (NaN = missing) -> leaf node per (row, tree);
    categorical nodes route by ``categorical_go_right`` where the stacked
    forest carries category bitmasks."""
    n = x.shape[0]
    feature = stacked["feature"]
    T = feature.shape[0]
    cat_mask = stacked["cat_mask"] if "cat_split" in stacked else None
    node = torch.zeros((n, T), dtype=torch.long, device=x.device)
    t_idx = torch.arange(T, device=x.device)[None, :].expand(n, T)
    for _ in range(stacked["depth"]):
        feat = feature[t_idx, node]                       # [n, T]
        thr = stacked["threshold"][t_idx, node]
        v = torch.gather(x, 1, feat.long())
        dfl = stacked["default_left"][t_idx, node]
        miss = torch.isnan(v)
        go_right = torch.where(miss, ~dfl, v >= thr)
        if cat_mask is not None:
            go_right = torch.where(stacked["cat_split"][t_idx, node],
                                   categorical_go_right(v, miss, dfl, cat_mask, t_idx, node),
                                   go_right)
        nxt = torch.where(go_right, stacked["right"][t_idx, node], stacked["left"][t_idx, node])
        node = torch.where(stacked["is_leaf"][t_idx, node], node, nxt.long())
    return node


def forest_leaf_values(stacked, x):
    """x: f32 tensor [n, d] -> each tree's output per row, [n, T]."""
    node = forest_leaf_nodes(stacked, x)
    T = node.shape[1]
    return stacked["leaf_value"][torch.arange(T, device=x.device)[None, :], node]


def forest_predict_margin(stacked, x, num_output_group=1, base_margin=0.0, tree_info=None):
    """Sum per-tree leaf outputs into per-group margins.

    stacked: dict of [T, N] tensors on x's device + "depth" int.
    Returns a tensor [n] (single group) or [n, num_output_group], where
    tree t adds to the column of its class ``tree_info[t]``.
    """
    leaf = forest_leaf_values(stacked, x)
    if num_output_group == 1:
        return leaf.sum(dim=1) + base_margin
    out = torch.zeros((x.shape[0], num_output_group), dtype=leaf.dtype, device=x.device)
    info = torch.as_tensor(np.asarray(tree_info, np.int64), device=x.device)
    return out.index_add_(1, info, leaf) + base_margin


# ------------------------------------------------------------- host predictor


def host_leaf_nodes(stacked, x):
    """Numpy twin of ``forest_leaf_nodes`` for tiny payloads (the same
    ``categorical_go_right`` at categorical nodes)."""
    x = np.asarray(x, np.float32)
    feature = np.asarray(stacked["feature"])
    threshold = np.asarray(stacked["threshold"])
    default_left = np.asarray(stacked["default_left"])
    left = np.asarray(stacked["left"])
    right = np.asarray(stacked["right"])
    is_leaf = np.asarray(stacked["is_leaf"])
    cat_mask = None
    if "cat_split" in stacked:
        cat_mask = np.asarray(stacked["cat_mask"])
        cat_split = np.asarray(stacked["cat_split"])
    n = x.shape[0]
    T = feature.shape[0]
    node = np.zeros((n, T), np.int64)
    t_idx = np.broadcast_to(np.arange(T)[None, :], (n, T))
    for _ in range(stacked["depth"]):
        feat = feature[t_idx, node]
        v = np.take_along_axis(x, feat.astype(np.int64), axis=1)
        dfl = default_left[t_idx, node]
        miss = np.isnan(v)
        go_right = np.where(miss, ~dfl, v >= threshold[t_idx, node])
        if cat_mask is not None:
            go_right = np.where(cat_split[t_idx, node],
                                categorical_go_right(v, miss, dfl, cat_mask, t_idx, node),
                                go_right)
        nxt = np.where(go_right, right[t_idx, node], left[t_idx, node])
        node = np.where(is_leaf[t_idx, node], node, nxt)
    return node


def host_predict_margin(stacked, x, num_output_group=1, base_margin=0.0, tree_info=None):
    """Host forest margin (numpy) with the contract of ``forest_predict_margin``."""
    node = host_leaf_nodes(stacked, x)
    leaf_value = np.asarray(stacked["leaf_value"])
    T = leaf_value.shape[0]
    leaf = leaf_value[np.arange(T)[None, :], node]        # [n, T]
    if num_output_group == 1:
        return leaf.sum(axis=1) + np.float32(base_margin)
    out = np.zeros((x.shape[0], num_output_group), np.float32)
    info = np.asarray(tree_info)
    for c in range(num_output_group):
        out[:, c] = leaf[:, info == c].sum(axis=1) + np.float32(base_margin)
    return out
