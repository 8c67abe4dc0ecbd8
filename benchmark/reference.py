"""The plain reference of a boosting round, in plain PyTorch.

It imports nothing of the program under test and takes nothing the program
made: it works the cuts and bins out again from the raw rows, and the
gradients, histograms, split gains and leaf values from its own bins and
its own arithmetic (float64 unless asked otherwise). What the program
produced (its trees and margins) it reads only to judge (``judge.py``).

Semantics (XGBoost's hist method, as the port documents them):

* cuts: per feature, the distinct non-missing values, sorted; where there
  are more than ``max_bin - 1``, the values at which the cumulative unit
  weight first reaches ``total * k / max_bin`` (k = 1 .. max_bin - 1,
  float64 targets), deduplicated; the cuts are the float32 midpoints of
  adjacent picks (one cut at value + 1 for a single-valued feature).
* bins: ``searchsorted(cuts, v, right)``, so ``bin(v) <= b`` iff
  ``v < cut[b]``; a missing value takes bin ``max_bin``.
* gain of a split with left sums (GL, HL) of a node with (G, H):
  ``0.5 * (T(GL)^2/(HL+lambda) + T(GR)^2/(HR+lambda) - T(G)^2/(H+lambda)) -
  gamma``, legal where both sides hold ``min_child_weight`` of hessian;
  T is L1 soft thresholding by alpha. The missing bin goes to either side,
  whichever scores higher (ties: right).
* a node splits where its best gain exceeds 1e-6; a leaf's value is
  ``eta * -T(G)/(H+lambda)``.
* ``binary:logistic``: p = sigmoid(m), g = p - y, h = max(p (1 - p), 1e-16).
* ``rank:ndcg``: LambdaMART over each query's pairs with differing labels,
  the RankNet gradient weighted by |delta NDCG| (gains 2^y - 1, discount
  1/log2(1 + rank), ranks by score with ties in row order).
"""

import numpy as np
import torch

MIN_SPLIT_LOSS = 1e-6


# ------------------------------------------------------------- cuts, bins


def _select_cuts(v, max_cuts):
    """Sorted non-missing f32 values of one feature -> its f32 cuts (numpy)."""
    if v.numel() == 0:
        return np.empty(0, np.float32)
    distinct, counts = torch.unique_consecutive(v, return_counts=True)
    nd = distinct.numel()
    if nd <= max_cuts:
        reps = distinct
    else:
        # unit weights: the cumulative weight at the end of each run of equal
        # values is its position, exact in float64
        cum = torch.cumsum(counts, 0).double()
        total = np.float32(v.numel())
        targets = total * (np.arange(1, max_cuts + 1) / (max_cuts + 1))
        picks = torch.searchsorted(cum, torch.as_tensor(targets, device=v.device), right=False)
        reps = distinct[torch.unique(torch.clamp(picks, 0, nd - 1))]
    if reps.numel() < 2:
        return (reps[:1] + 1.0).cpu().numpy().astype(np.float32)
    return ((reps[:-1] + reps[1:]) / 2.0).cpu().numpy().astype(np.float32)


def sketch_cuts(x, max_bin):
    """f32 [n, d] features on a device -> list of d f32 numpy cut arrays."""
    out = []
    for f in range(x.shape[1]):
        v = torch.sort(x[:, f].contiguous()).values       # NaN sorts last
        valid = int((~torch.isnan(v)).sum())
        out.append(_select_cuts(v[:valid], max_bin - 1))
    return out


def apply_cuts(x, cuts, max_bin):
    """f32 [n, d] features -> int16 [n, d] bins (``max_bin`` = missing)."""
    n, d = x.shape
    bins = torch.empty((n, d), dtype=torch.int16, device=x.device)
    for f in range(d):
        col = x[:, f].contiguous()
        c = torch.as_tensor(cuts[f], device=x.device)
        idx = torch.searchsorted(c, col, right=True)
        bins[:, f] = torch.where(torch.isnan(col), max_bin, idx).to(torch.int16)
    return bins


# ----------------------------------------------------------- objectives


def logistic_grad_hess(m, y, w):
    p = 1.0 / (1.0 + torch.exp(-m))
    return (p - y) * w, torch.clamp(p * (1.0 - p), min=1e-16) * w


def query_blocks(sizes, budget=1 << 24):
    """Query sizes -> [(row_index int64 [G, M] with -1 padding)]: queries in
    order of size, each block as many as keep G * M^2 within ``budget``."""
    sizes = np.asarray(sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    order = np.argsort(sizes, kind="stable")
    blocks, members = [], []

    def close():
        m = int(sizes[members[-1]])
        block = np.full((len(members), m), -1, np.int64)
        for i, q in enumerate(members):
            block[i, :sizes[q]] = np.arange(starts[q], starts[q] + sizes[q])
        blocks.append(block)

    for q in order:
        if members and (len(members) + 1) * int(sizes[q]) ** 2 > budget:
            close()
            members = []
        members.append(q)
    if members:
        close()
    return blocks


def ndcg_grad_hess(m, y, w, blocks):
    """LambdaMART rank:ndcg gradients of every row, query by query."""
    grad, hess = torch.zeros_like(m), torch.zeros_like(m)
    for block in blocks:
        idx = torch.as_tensor(block, device=m.device)
        valid = idx >= 0
        safe = torch.clamp(idx, min=0)
        s = torch.where(valid, m[safe], 0.0)
        lab = torch.where(valid, y[safe], float("-inf"))
        wt = torch.where(valid, w[safe], 0.0)
        M = idx.shape[1]
        key = torch.where(valid, -s, float("inf"))
        order = torch.argsort(key, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True) + 1
        gain = torch.where(valid, torch.exp2(torch.where(valid, lab, 0.0)) - 1.0, 0.0)
        disc = 1.0 / torch.log2(1.0 + rank.to(m.dtype))
        ideal = torch.sort(gain, dim=1, descending=True).values
        ideal_disc = 1.0 / torch.log2(2.0 + torch.arange(M, dtype=m.dtype, device=m.device))
        max_dcg = torch.clamp((ideal * ideal_disc).sum(dim=1), min=1e-12)
        delta = ((gain[:, :, None] - gain[:, None, :]).abs()
                 * (disc[:, :, None] - disc[:, None, :]).abs() / max_dcg[:, None, None])
        rho = 1.0 / (1.0 + torch.exp(s[:, :, None] - s[:, None, :]))
        prefer = (lab[:, :, None] > lab[:, None, :]) & valid[:, :, None] & valid[:, None, :]
        lam = torch.where(prefer, rho * delta, 0.0)
        hp = torch.where(prefer, rho * (1.0 - rho) * delta, 0.0)
        g = (lam.sum(dim=1) - lam.sum(dim=2)) * wt
        h = torch.clamp(hp.sum(dim=2) + hp.sum(dim=1), min=1e-16) * wt
        grad.index_put_((safe[valid],), g[valid])
        hess.index_put_((safe[valid],), h[valid])
    return grad, hess


class Objective:
    """The configuration's objective over one split's rows."""

    def __init__(self, params, labels, groups, device, dtype):
        self.name = params["objective"]
        self.y = torch.as_tensor(labels, device=device).to(dtype)
        self.w = torch.ones_like(self.y)
        self.blocks = query_blocks(groups) if self.name == "rank:ndcg" else None
        if self.name not in ("binary:logistic", "rank:ndcg"):
            raise ValueError("no reference for objective {}".format(self.name))

    def base_margin(self, base_score=0.5):
        if self.name == "binary:logistic":
            return float(np.log(base_score / (1.0 - base_score)))
        return float(base_score)

    def grad_hess(self, m):
        if self.blocks is not None:
            return ndcg_grad_hess(m, self.y, self.w, self.blocks)
        return logistic_grad_hess(m, self.y, self.w)


# ------------------------------------------------------ histograms, gains


def histograms(bins, g, h, local, width, num_bins, feature_chunk=8):
    """Per-node gradient and hessian histograms [width, d, num_bins] in g's
    dtype over the rows with ``local`` (int64 [n]) in [0, width)."""
    n, d = bins.shape
    rows = torch.nonzero(local >= 0).squeeze(1)
    node = local[rows]
    gr, hr = g[rows], h[rows]
    G = torch.zeros(width * d * num_bins, dtype=g.dtype, device=g.device)
    H = torch.zeros_like(G)
    for f0 in range(0, d, feature_chunk):
        f1 = min(d, f0 + feature_chunk)
        fb = bins[rows, f0:f1].long()
        feats = torch.arange(f0, f1, device=g.device)[None, :]
        idx = ((node[:, None] * d + feats) * num_bins + fb).reshape(-1)
        G.index_add_(0, idx, gr[:, None].expand(-1, f1 - f0).reshape(-1))
        H.index_add_(0, idx, hr[:, None].expand(-1, f1 - f0).reshape(-1))
    return G.view(width, d, num_bins), H.view(width, d, num_bins)


def _thr(g, alpha):
    return torch.sign(g) * torch.clamp(g.abs() - alpha, min=0.0) if alpha else g


def _score(g, h, lam, alpha):
    t = _thr(g, alpha)
    return t * t / (h + lam)


def leaf_weight(gt, ht, p):
    w = -_thr(gt, p["alpha"]) / (ht + p["lambda"])
    if p["max_delta_step"] > 0:
        w = torch.clamp(w, -p["max_delta_step"], p["max_delta_step"])
    return w


def split_gains(G, H, num_cuts, p, child_weight=None):
    """[W, d, B] histograms -> (gain with the missing bin right, gain with
    it left, each [W, d, B-1] with -inf where illegal; node totals g, h).
    ``child_weight``: the least hessian a child must hold, if not the job's
    ``min_child_weight``."""
    mcw = p["min_child_weight"] if child_weight is None else child_weight
    W, d, B = G.shape
    nb = B - 1
    gt, ht = G[:, 0, :].sum(-1), H[:, 0, :].sum(-1)
    gm, hm = G[:, :, nb], H[:, :, nb]
    gc, hc = torch.cumsum(G[:, :, :nb], -1), torch.cumsum(H[:, :, :nb], -1)
    lam, alpha = p["lambda"], p["alpha"]
    parent = _score(gt, ht, lam, alpha)[:, None, None]
    legal = (torch.arange(nb, device=G.device)[None, :] < num_cuts[:, None])[None]

    def gain(gl, hl):
        gr, hr = gt[:, None, None] - gl, ht[:, None, None] - hl
        ok = (hl >= mcw) & (hr >= mcw) & legal
        raw = 0.5 * (_score(gl, hl, lam, alpha) + _score(gr, hr, lam, alpha) - parent)
        return torch.where(ok, raw - p["gamma"], float("-inf"))

    return gain(gc, hc), gain(gc + gm[:, :, None], hc + hm[:, :, None]), gt, ht


def best_splits(G, H, num_cuts, p):
    """-> per node (best gain, feature, bin, default_left), the first
    maximal (feature, bin) winning ties, missing right on a tie."""
    right, left, gt, ht = split_gains(G, H, num_cuts, p)
    take_left = left > right
    gain = torch.where(take_left, left, right)
    W, d, nb = gain.shape
    flat = gain.reshape(W, -1)
    best = torch.argmax(flat, dim=1)
    return (flat.gather(1, best[:, None])[:, 0], best // nb, best % nb,
            take_left.reshape(W, -1).gather(1, best[:, None])[:, 0], gt, ht)


def tree_params(params):
    """The tree-growth parameters of a job, with XGBoost's defaults."""
    p = dict(params)
    out = {
        "eta": float(p.get("eta", 0.3)),
        "lambda": float(p.get("lambda", 1.0)),
        "alpha": float(p.get("alpha", 0.0)),
        "gamma": float(p.get("gamma", 0.0)),
        "min_child_weight": float(p.get("min_child_weight", 1.0)),
        "max_delta_step": float(p.get("max_delta_step", 0.0)),
        "grow_policy": p.get("grow_policy", "depthwise"),
        "max_depth": int(p.get("max_depth", 6)),
        "max_leaves": int(p.get("max_leaves", 0) or 0),
        "max_bin": int(p.get("max_bin", 256)),
    }
    out["depth_cap"] = out["max_depth"] if out["max_depth"] > 0 else out["max_leaves"]
    return out


# ---------------------------------------------------- trees (the builder)


def route(bins, node, tree, num_bins):
    """One routing step of every row at an internal node -> its child."""
    feat = torch.as_tensor(tree["feature"], device=bins.device).long()[node]
    split = torch.as_tensor(tree["bin"], device=bins.device).long()[node]
    dleft = torch.as_tensor(tree["default_left"], device=bins.device)[node]
    b = bins.gather(1, feat[:, None])[:, 0].long()
    right = torch.where(b == num_bins - 1, ~dleft, b > split)
    return torch.where(right, torch.as_tensor(tree["right"], device=bins.device).long()[node],
                       torch.as_tensor(tree["left"], device=bins.device).long()[node])


def leaf_of_rows(bins, tree, num_bins, depth):
    """Each row's leaf slot in a tree of at most ``depth`` levels."""
    node = torch.zeros(bins.shape[0], dtype=torch.long, device=bins.device)
    is_leaf = torch.as_tensor(tree["is_leaf"], device=bins.device)
    for _ in range(depth):
        node = torch.where(is_leaf[node], node, route(bins, node, tree, num_bins))
    return node


def slot_depths(tree):
    """Depth of every slot reachable from the root of a tree (-1 where
    unreachable)."""
    depth = np.full(len(tree["feature"]), -1, np.int64)
    depth[0] = 0
    frontier = [0]
    while frontier:
        nxt = []
        for s in frontier:
            if not tree["is_leaf"][s]:
                for c in (int(tree["left"][s]), int(tree["right"][s])):
                    depth[c] = depth[s] + 1
                    nxt.append(c)
        frontier = nxt
    return depth


def _empty_tree(slots):
    return {"feature": np.zeros(slots, np.int32), "bin": np.zeros(slots, np.int32),
            "default_left": np.zeros(slots, bool), "is_leaf": np.ones(slots, bool),
            "leaf_value": np.zeros(slots, np.float32), "left": np.arange(slots, dtype=np.int32),
            "right": np.arange(slots, dtype=np.int32), "sum_hess": np.zeros(slots, np.float32),
            "gain": np.zeros(slots, np.float32)}


def build_tree(bins, g, h, num_cuts, p, num_bins):
    """Grow one tree from (g, h) in their dtype (depthwise: slot i's
    children at 2i+1, 2i+2; lossguide: split step t makes slots 2t+1, 2t+2)
    -> (padded tree of numpy arrays, each node's hessian sum and each
    split's gain among them, each row's leaf value in g's dtype). The
    control's builder: the judge holds the program's trees to the same
    arithmetic in float64."""
    if p["grow_policy"] == "lossguide":
        return _build_lossguide(bins, g, h, num_cuts, p, num_bins)
    return _build_depthwise(bins, g, h, num_cuts, p, num_bins)


def _build_depthwise(bins, g, h, num_cuts, p, num_bins):
    D = p["max_depth"]
    tree = _empty_tree(2 ** (D + 1) - 1)
    node = torch.zeros(bins.shape[0], dtype=torch.long, device=bins.device)
    values = torch.zeros(2 ** (D + 1) - 1, dtype=g.dtype, device=g.device)
    for level in range(D + 1):
        first, width = 2 ** level - 1, 2 ** level
        local = torch.where(node >= first, node - first, -1)
        if level == D:
            gt = torch.zeros(width, dtype=g.dtype, device=g.device)
            ht = torch.zeros_like(gt)
            rows = local >= 0
            gt.index_add_(0, local[rows], g[rows])
            ht.index_add_(0, local[rows], h[rows])
            values[first:first + width] = p["eta"] * leaf_weight(gt, ht, p)
            tree["sum_hess"][first:first + width] = ht.float().cpu().numpy()
            break
        G, H = histograms(bins, g, h, local, width, num_bins)
        gain, feat, split, dleft, gt, ht = best_splits(G, H, num_cuts, p)
        can = (gain > MIN_SPLIT_LOSS).cpu().numpy()
        sl = slice(first, first + width)
        tree["feature"][sl] = feat.cpu().numpy()
        tree["bin"][sl] = split.cpu().numpy()
        tree["default_left"][sl] = dleft.cpu().numpy()
        tree["is_leaf"][sl] = ~can
        tree["sum_hess"][sl] = ht.float().cpu().numpy()
        tree["gain"][sl] = np.where(can, gain.float().cpu().numpy(), 0.0)
        ids = np.arange(first, first + width)
        tree["left"][sl] = np.where(can, 2 * ids + 1, ids)
        tree["right"][sl] = np.where(can, 2 * ids + 2, ids)
        values[sl] = torch.where(torch.as_tensor(can, device=g.device), 0.0,
                                 p["eta"] * leaf_weight(gt, ht, p))
        inner = (local >= 0) & torch.as_tensor(can, device=g.device)[torch.clamp(local, min=0)]
        node = torch.where(inner, route(bins, node, tree, num_bins), node)
    tree["leaf_value"] = np.where(tree["is_leaf"], values.float().cpu().numpy(), 0.0).astype(
        np.float32)
    leaf = leaf_of_rows(bins, tree, num_bins, D)
    return tree, values[leaf]


def _build_lossguide(bins, g, h, num_cuts, p, num_bins):
    L = p["max_leaves"]
    slots = 2 * L - 1
    tree = _empty_tree(slots)
    dev = g.device
    node = torch.zeros(bins.shape[0], dtype=torch.long, device=dev)
    cand = np.full(slots, -np.inf)
    cand_split = {}
    totals = torch.zeros((slots, 2), dtype=g.dtype, device=dev)
    depth = np.zeros(slots, np.int64)

    def scan(local, width, ids):
        G, H = histograms(bins, g, h, local, width, num_bins)
        gain, feat, split, dleft, gt, ht = best_splits(G, H, num_cuts, p)
        for k, s in enumerate(ids):
            open_ = depth[s] < p["depth_cap"]
            cand[s] = float(gain[k]) if open_ else -np.inf
            cand_split[s] = (int(feat[k]), int(split[k]), bool(dleft[k]))
            totals[s, 0], totals[s, 1] = gt[k], ht[k]

    scan(torch.zeros_like(node), 1, [0])
    for t in range(L - 1):
        gains = np.where(tree["is_leaf"], cand, -np.inf)
        leaf = int(np.argmax(gains))
        if not gains[leaf] > MIN_SPLIT_LOSS:
            break
        a, b = 2 * t + 1, 2 * t + 2
        tree["feature"][leaf], tree["bin"][leaf], tree["default_left"][leaf] = cand_split[leaf]
        tree["is_leaf"][leaf] = False
        tree["gain"][leaf] = gains[leaf]
        tree["left"][leaf], tree["right"][leaf] = a, b
        cand[leaf] = -np.inf
        depth[a] = depth[b] = depth[leaf] + 1
        inside = node == leaf
        node = torch.where(inside, route(bins, node, tree, num_bins), node)
        local = torch.where(node == a, 0, torch.where(node == b, 1, -1))
        scan(local, 2, [a, b])
    values = p["eta"] * leaf_weight(totals[:, 0], totals[:, 1], p)
    is_leaf = torch.as_tensor(tree["is_leaf"], device=dev)
    values = torch.where(is_leaf, values, 0.0)
    tree["leaf_value"] = values.float().cpu().numpy()
    tree["sum_hess"] = totals[:, 1].float().cpu().numpy()
    return tree, values[node]
