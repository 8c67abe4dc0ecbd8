"""What decides ``correct``: the program's outputs held to the reference.

What is judged is the model the window built, as ``train`` returns it: the
forest's compact trees, whose thresholds the reference maps back to bins
through its own cuts (a threshold that is not one of them reads
``ILLEGAL``), and the forest's own predictions (``Forest.predict_margin``)
on the validation rows and on a sample of the training rows drawn from the
seed. The reference (``reference.py``) works the cuts and bins out again
from the raw rows, replays the forest's trees over its own bins in float64
and, as the job does, in float32 (``GRAD_MARGINS``), and at each judged
round takes the gradients in float64 at the float32 margins, builds every
node's histograms from the rows the tree routes there, and judges the tree
node by node:

``split_gap``   how far the gain of the tree's split (feature, bin, default
                direction) lies below the best gain at that node; for a
                node left a leaf above the depth cap, how far its best gain
                lies above the 1e-6 a split needs; under lossguide, at each
                step of a best-first replay over the tree, how far the best
                gain of the open leaves lies above that of the leaf the tree
                expanded. Each is over the larger of the node's best gain
                and the tree's median best gain. Every gain and every
                child's hessian is taken with the bound of the error that
                float32 sums carry (``ERR_SCALE``): a split the program may
                have found legal or best in float32 is held legal or best.
``leaf_gap``    |tree leaf value - reference leaf value| over the larger of
                that reference value and the tree's median one.
``cover_gap``   at round 0, |tree node hessian (the model's ``sum_hess``) -
                the float64 hessian of the rows its thresholds route there|
                over the larger of that hessian and the tree's median node
                hessian: ties the saved thresholds to the rows the round
                trained on. At round 0 every row sits at the base margin:
                ``binary:logistic`` gives each the hessian 0.25, so any
                float32 summation gives exact sums, which later rounds'
                sums of unequal hessians in float32 do not.
``margin_gap``  max |forest margin - replayed margin| over the sampled
                training rows; ``valid_margin_gap`` over the validation rows.
``cuts_differ`` features whose cuts differ in any bit; ``bins_differ``
                (row, feature) bins that differ, training and validation.

Each number is compared with its limit in ``limits/<cell>.json``.
"""

import numpy as np
import torch

from . import reference as ref

# the reading of a split the reference finds illegal, or of a non-number
ILLEGAL = 1e9
# float32's unit roundoff, and the number of it a float32 histogram sum may
# be off by per unit of the mass summed into a node and its ancestors: a
# node below the root may be its parent's histogram less its sibling's,
# and the split scan sums up to 256 bins in a row. A child's hessian and
# gradient sums are held to carry ERR_SCALE * EPS32 * (sum of h, of |g|,
# over the rows of the node and of each of its ancestors).
EPS32 = 2.0 ** -24
ERR_SCALE = 32.0
# training rows whose forest margins are compared, drawn from the seed
TRAIN_SAMPLE = 1 << 20
# the precision in which the reference sums a round's margins before it
# takes its gradients: float32, the job's, one add a round in round order.
# rank:ndcg's gradients depend on the documents' ranks by margin, which
# jump where two margins tie or cross: a float64 sum orders near-ties that
# float32 sums round to one value (or order the other way) differently, and
# moves whole queries' gradients. Float32 adds are correctly rounded, so
# the reference's float32 sums are the ones a sound float32 run makes.
GRAD_MARGINS = torch.float32
NUMBERS = ("cuts_differ", "bins_differ", "split_gap", "leaf_gap", "cover_gap", "margin_gap",
           "valid_margin_gap")


class Reference:
    """The reference's own view of one run's rows: cuts, bins, objective."""

    def __init__(self, inputs, params, device, dtype=torch.float64):
        self.p = ref.tree_params(params)
        self.device, self.dtype = device, dtype
        self.num_bins = self.p["max_bin"] + 1
        x = torch.as_tensor(inputs.x_train, device=device)
        self.cuts = ref.sketch_cuts(x, self.p["max_bin"])
        self.bins = ref.apply_cuts(x, self.cuts, self.p["max_bin"])
        del x
        xv = torch.as_tensor(inputs.x_valid, device=device)
        self.valid_bins = ref.apply_cuts(xv, self.cuts, self.p["max_bin"])
        del xv
        self.num_cuts = torch.as_tensor([len(c) for c in self.cuts], device=device)
        self.objective = ref.Objective(params, inputs.y_train, inputs.groups_train, device,
                                       dtype)
        self.base = self.objective.base_margin()


def bins_differ(mine, theirs, chunk=1 << 20):
    """Count of differing entries of int16 device bins and the program's
    host uint16 (or uint8) bins."""
    out = 0
    for lo in range(0, mine.shape[0], chunk):
        t = torch.as_tensor(np.asarray(theirs[lo:lo + chunk], np.int32), device=mine.device)
        out += int((mine[lo:lo + chunk].int() != t).sum())
    return out


def forest_tree(tree, cuts):
    """A compact tree of the program's forest (``feature``, ``threshold``,
    ``default_left``, ``left``, ``right``, ``value``, ``sum_hess``,
    ``gain``) -> the
    judge's arrays, each internal node's threshold mapped to the bin of the
    reference's ``cuts`` at which it lies. ``matched`` is False where the
    threshold is none of them; such a node routes as if it split below
    that bin and reads ILLEGAL."""
    left = np.asarray(tree.left, np.int64)
    k = len(left)
    is_leaf = left < 0
    ids = np.arange(k)
    feature = np.asarray(tree.feature, np.int64)
    threshold = np.asarray(tree.threshold, np.float32)
    bins = np.zeros(k, np.int64)
    matched = np.ones(k, bool)
    for s in np.nonzero(~is_leaf)[0]:
        c = cuts[feature[s]] if 0 <= feature[s] < len(cuts) else np.empty(0, np.float32)
        b = int(np.searchsorted(c, threshold[s], side="left"))
        matched[s] = b < len(c) and c[b].view(np.uint32) == threshold[s].view(np.uint32)
        bins[s] = b if matched[s] else b - 1
    return {"feature": np.where(is_leaf, 0, feature), "bin": bins,
            "default_left": np.asarray(tree.default_left, bool), "is_leaf": is_leaf,
            "leaf_value": np.where(is_leaf, np.asarray(tree.value, np.float32), 0.0),
            "left": np.where(is_leaf, ids, left),
            "right": np.where(is_leaf, ids, np.asarray(tree.right, np.int64)),
            "sum_hess": np.asarray(tree.sum_hess, np.float64),
            "gain": np.asarray(tree.gain, np.float64), "matched": matched}


def tree_depth(tree):
    return int(ref.slot_depths(tree).max())


def node_counts(bins, tree, num_bins):
    """Rows that pass through each slot of a tree (the work model's
    per-node row counts), float64 numpy."""
    depth = ref.slot_depths(tree)
    leaf = ref.leaf_of_rows(bins, tree, num_bins, int(depth.max()))
    counts = torch.bincount(leaf, minlength=len(depth)).cpu().numpy().astype(np.float64)
    for s in sorted(np.nonzero(depth >= 0)[0], key=lambda s: -depth[s]):
        if not tree["is_leaf"][s]:
            counts[s] = counts[tree["left"][s]] + counts[tree["right"][s]]
    return counts


def candidates(G, H, num_cuts, p, dG, dH):
    """[W, d, B] float64 histograms and per-node error bounds dG, dH [W] ->
    per candidate split [W, d, B-1, 2] (the missing bin right, then left):
    its gain, the bound of that gain's float32 error, and its lesser
    child's hessian; and whether its bin is a cut [1, d, B-1, 1]."""
    nb = G.shape[2] - 1
    gt, ht = G[:, 0, :].sum(-1), H[:, 0, :].sum(-1)
    gc, hc = torch.cumsum(G[:, :, :nb], -1), torch.cumsum(H[:, :, :nb], -1)
    gl = torch.stack([gc, gc + G[:, :, nb:]], -1)
    hl = torch.stack([hc, hc + H[:, :, nb:]], -1)
    gr, hr = gt[:, None, None, None] - gl, ht[:, None, None, None] - hl
    lam, alpha = p["lambda"], p["alpha"]

    def weight(g, h):
        return ref._thr(g, alpha) / (h + lam)

    wl, wr, wp = weight(gl, hl), weight(gr, hr), weight(gt, ht)[:, None, None, None]
    parent = ref._score(gt, ht, lam, alpha)[:, None, None, None]
    gain = 0.5 * (ref._score(gl, hl, lam, alpha) + ref._score(gr, hr, lam, alpha)
                  - parent) - p["gamma"]
    tol = ((wl.abs() + wr.abs() + wp.abs()) * dG[:, None, None, None]
           + 0.5 * (wl * wl + wr * wr + wp * wp) * dH[:, None, None, None])
    cut = (torch.arange(nb, device=G.device)[None, :] < num_cuts[:, None])[None, :, :, None]
    return gain, tol, torch.minimum(hl, hr), cut


def judge_tree(R, tree, margins, err_scale=ERR_SCALE):
    """One tree against the reference at the margins before its round ->
    (split gap, leaf gap, cover gap), with float32's error bound taken
    ``err_scale`` times."""
    p = R.p
    g, h = R.objective.grad_hess(margins.to(R.dtype))
    depth = ref.slot_depths(tree)
    slots_n = len(depth)
    is_leaf = np.asarray(tree["is_leaf"])
    internal = (~is_leaf) & (depth >= 0)
    matched = np.asarray(tree.get("matched", np.ones(slots_n, bool)))
    parent = np.full(slots_n, -1, np.int64)
    for s in np.nonzero(internal)[0]:
        parent[tree["left"][s]] = parent[tree["right"][s]] = s
    # the mass summed into each node and its ancestors: sum h, sum |g|
    path_h, path_g = np.zeros(slots_n), np.zeros(slots_n)
    best, best_lo, chosen_hi = (np.full(slots_n, -np.inf) for _ in range(3))
    ref_leaf, ref_hess = np.zeros(slots_n), np.zeros(slots_n)
    node = torch.zeros(R.bins.shape[0], dtype=torch.long, device=R.device)
    internal_t = torch.as_tensor(internal, device=R.device)
    mcw = p["min_child_weight"]
    for k in range(int(depth.max()) + 1):
        slots = np.nonzero(depth == k)[0]
        lut = np.full(slots_n, -1, np.int64)
        lut[slots] = np.arange(len(slots))
        local = torch.as_tensor(lut, device=R.device)[node]
        W = len(slots)
        rows = local >= 0
        gt = torch.zeros(W, dtype=g.dtype, device=R.device)
        ht, gabs = torch.zeros_like(gt), torch.zeros_like(gt)
        gt.index_add_(0, local[rows], g[rows])
        ht.index_add_(0, local[rows], h[rows])
        gabs.index_add_(0, local[rows], g[rows].abs())
        up = np.maximum(parent[slots], 0)
        root = parent[slots] < 0
        path_h[slots] = ht.cpu().numpy() + np.where(root, 0.0, path_h[up])
        path_g[slots] = gabs.cpu().numpy() + np.where(root, 0.0, path_g[up])
        if k < p["depth_cap"]:
            G, H = ref.histograms(R.bins, g, h, local, W, R.num_bins)
            dH = torch.as_tensor(err_scale * EPS32 * path_h[slots], device=R.device)
            dG = torch.as_tensor(err_scale * EPS32 * path_g[slots], device=R.device)
            gain, tol, hmin, cut = candidates(G, H, R.num_cuts, p, dG, dH)
            sure = cut & (hmin >= mcw + dH[:, None, None, None])
            best[slots] = torch.where(sure, gain, -np.inf).amax((1, 2, 3)).cpu().numpy()
            best_lo[slots] = torch.where(sure, gain - tol, -np.inf).amax((1, 2, 3)).cpu().numpy()
            inner = np.nonzero(internal[slots] & matched[slots])[0]
            if len(inner):
                s = slots[inner]
                ix = torch.as_tensor(inner, device=R.device)
                f = torch.as_tensor(tree["feature"][s], device=R.device).long()
                b = torch.as_tensor(tree["bin"][s], device=R.device).long()
                dl = torch.as_tensor(tree["default_left"][s], device=R.device).long()
                maybe = cut & (hmin >= mcw - dH[:, None, None, None])
                pick = (ix, f, b, dl)
                chosen_hi[s] = torch.where(maybe[pick], gain[pick] + tol[pick],
                                           -np.inf).cpu().numpy()
        ref_leaf[slots] = (p["eta"] * ref.leaf_weight(gt, ht, p)).cpu().numpy()
        ref_hess[slots] = ht.cpu().numpy()
        moving = (local >= 0) & internal_t[node]
        node = torch.where(moving, ref.route(R.bins, node, tree, R.num_bins), node)

    finite = internal & np.isfinite(best)
    med = float(np.median(best[finite])) if finite.any() else 1.0
    med = med if med > 0 else 1.0
    gaps = [0.0]
    if internal.any():
        # a split the reference finds illegal, or a threshold that is no
        # cut, has no gain (-inf) and reads ILLEGAL
        with np.errstate(invalid="ignore"):
            lost = np.maximum(best_lo[internal] - chosen_hi[internal], 0.0)
        lost = np.where(np.isfinite(chosen_hi[internal]), lost, np.inf)
        gaps.append(float(np.max(lost / np.maximum(best[internal], med))))
    open_leaves = is_leaf & (depth >= 0) & (depth < p["depth_cap"])
    if p["grow_policy"] == "lossguide":
        gaps.append(_order_gap(tree, depth, best, best_lo, chosen_hi, med, p))
    elif open_leaves.any():
        excess = np.maximum(best_lo[open_leaves] - ref.MIN_SPLIT_LOSS, 0.0)
        gaps.append(float(np.max(excess / np.maximum(best[open_leaves], med))))
    reached = depth >= 0
    leaves = is_leaf & reached
    mine = np.asarray(tree["leaf_value"], np.float64)[leaves]
    theirs = ref_leaf[leaves]
    scale = np.maximum(np.abs(theirs), np.median(np.abs(theirs)))
    leaf_gap = float(np.max(np.abs(mine - theirs) / np.maximum(scale, 1e-30)))
    hess = ref_hess[reached]
    cover = np.asarray(tree["sum_hess"], np.float64)[reached]
    scale = np.maximum(hess, np.median(hess))
    cover_gap = float(np.max(np.abs(cover - hess) / np.maximum(scale, 1e-30)))
    return tuple(min(x, ILLEGAL) if x == x else ILLEGAL
                 for x in (max(gaps), leaf_gap, cover_gap))


def _order_gap(tree, depth, best, best_lo, chosen_hi, med, p):
    """Lossguide: replay best-first expansion over the tree. At each step
    the open leaves are the root and the children (above the depth cap) of
    the nodes expanded so far; of those the tree split, the one with the
    highest gain the tree stores (the key the builder expanded by) is
    expanded next, so the replay follows the builder's own order. The gap
    is how far the best reference gain of an open leaf lies above that of
    the expanded one's split, each with its float32 error bound. Where
    fewer than max_leaves - 1 nodes were split, no leaf left open may gain
    more than 1e-6."""
    left, right = np.asarray(tree["left"]), np.asarray(tree["right"])
    is_leaf = np.asarray(tree["is_leaf"])
    split = set(int(s) for s in np.nonzero(~is_leaf & (depth >= 0))[0])
    order = np.asarray(tree["gain"], np.float64)
    frontier, gap, made = {0}, 0.0, 0
    while frontier & split:
        top = max(best_lo[f] for f in frontier)
        scale = max(max(best[f] for f in frontier), med)
        s = max(frontier & split, key=lambda f: order[f])
        if not np.isfinite(chosen_hi[s]):
            return np.inf
        gap = max(gap, (top - chosen_hi[s]) / scale)
        frontier.discard(s)
        made += 1
        for c in (int(left[s]), int(right[s])):
            if depth[c] < p["depth_cap"]:
                frontier.add(c)
    if made < p["max_leaves"] - 1 and frontier:
        top = max(best_lo[f] for f in frontier)
        scale = max(max(best[f] for f in frontier), med)
        gap = max(gap, max(top - ref.MIN_SPLIT_LOSS, 0.0) / scale)
    return float(gap)


class Program:
    """What the program produced: its cuts, its training and validation
    bins (host numpy), the trees of each committed round (the judge's
    arrays), and its margins (host float32) on the training rows
    ``train_rows`` (all where None) and on the validation rows."""

    def __init__(self, cuts, bins, valid_bins, trees, margins, valid_margins, train_rows=None):
        self.cuts, self.bins, self.valid_bins = cuts, bins, valid_bins
        self.trees, self.margins, self.valid_margins = trees, margins, valid_margins
        self.train_rows = train_rows


def train_sample(seed, n):
    """The training rows whose forest margins are compared: TRAIN_SAMPLE of
    them (all, where there are fewer) drawn from the seed, in order."""
    if n <= TRAIN_SAMPLE:
        return np.arange(n)
    rng = np.random.RandomState((seed + 1) % (1 << 32))
    return np.sort(rng.choice(n, size=TRAIN_SAMPLE, replace=False))


def check(R, prog, judged, counted=(), err_scale=ERR_SCALE):
    """-> ({number: value}, {round: (train counts, valid counts)} of the
    ``counted`` rounds, rounds judged)."""
    out = {"cuts_differ": sum(
        int(not np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                               np.asarray(b, np.float32).view(np.uint32)))
        for a, b in zip(R.cuts, prog.cuts)) + abs(len(R.cuts) - len(prog.cuts))}
    out["bins_differ"] = (bins_differ(R.bins, prog.bins)
                          + bins_differ(R.valid_bins, prog.valid_bins))
    m = torch.full((R.bins.shape[0],), R.base, dtype=torch.float64, device=R.device)
    m32 = torch.full_like(m, R.base, dtype=torch.float32)
    mv = torch.full((R.valid_bins.shape[0],), R.base, dtype=torch.float64, device=R.device)
    gaps = {"split_gap": 0.0, "leaf_gap": 0.0, "cover_gap": 0.0}
    counts = {}
    judged = sorted(set(r for r in judged if 0 <= r < len(prog.trees)))
    for r, tree in enumerate(prog.trees):
        if r in judged:
            for name, value in zip(gaps, judge_tree(R, tree, margins_at(m, m32), err_scale)):
                if name != "cover_gap" or r == 0:
                    gaps[name] = max(gaps[name], value)
        if r in counted:
            counts[r] = (node_counts(R.bins, tree, R.num_bins),
                         node_counts(R.valid_bins, tree, R.num_bins))
        depth = tree_depth(tree)
        values = torch.as_tensor(np.asarray(tree["leaf_value"], np.float64), device=R.device)
        leaf = ref.leaf_of_rows(R.bins, tree, R.num_bins, depth)
        m += values[leaf]
        m32 += values.float()[leaf]
        mv += values[ref.leaf_of_rows(R.valid_bins, tree, R.num_bins, depth)]
    out.update(gaps)
    if prog.train_rows is not None:
        m = m[torch.as_tensor(prog.train_rows, device=R.device)]
    out["margin_gap"] = _gap(m, prog.margins)
    out["valid_margin_gap"] = _gap(mv, prog.valid_margins)
    return out, counts, judged


def margins_at(m64, m32):
    """The margins at which a round's gradients are taken: the float32
    replay where ``GRAD_MARGINS`` is float32, else the float64 one."""
    return m32 if GRAD_MARGINS == torch.float32 else m64


def _gap(replayed, margins):
    mine = torch.as_tensor(np.asarray(margins, np.float64), device=replayed.device)
    if mine.shape != replayed.shape:
        return ILLEGAL
    gap = float((replayed - mine).abs().max()) if len(mine) else 0.0
    return gap if gap == gap else ILLEGAL


def verdict(numbers, limits):
    """-> (correct, failed count, [(name, value, limit)]). A number that is
    not a number fails."""
    rows, failed = [], 0
    for name in NUMBERS:
        value, limit = numbers[name], limits[name]
        if not (value <= limit):
            failed += 1
        rows.append((name, value, limit))
    return failed == 0, failed, rows


FAULTS = ("unchanged", "half", "altered")


def control(R, inputs, rounds, dtype=torch.bfloat16, fault=None):
    """The reference put in the program's place -> a ``Program`` of
    ``rounds`` rounds. In bfloat16 it is the control (the nearest precision
    below the float32 the job states): the rows and cut midpoints rounded
    to bfloat16 (its own cuts and bins), gradients, histograms, gains, leaf
    values and margins in bfloat16. In float32 it carries one planted fault
    of ``FAULTS``: ``unchanged``, round 1 leaves the margins as they were;
    ``half``, every round's gradients over half of the rows, doubled (the
    mean over the rest); ``altered``, each tree's largest leaf value
    sign-flipped where it is made, margins following it."""
    p = R.p
    bins, valid_bins, cuts = R.bins, R.valid_bins, R.cuts
    if dtype != torch.float32:
        cuts = [np.asarray(torch.as_tensor(c).to(dtype).float().numpy()) for c in R.cuts]
        bins, valid_bins = (
            ref.apply_cuts(torch.as_tensor(x, device=R.device).to(dtype).float(), cuts,
                           p["max_bin"])
            for x in (inputs.x_train, inputs.x_valid))
    obj = ref.Objective(dict(objective=R.objective.name), inputs.y_train,
                        inputs.groups_train, R.device, dtype)
    n = bins.shape[0]
    keep = (torch.arange(n, device=R.device) % 2 == 0).to(dtype) * 2
    m = torch.full((n,), R.base, dtype=dtype, device=R.device)
    mv = torch.full((valid_bins.shape[0],), R.base, dtype=dtype, device=R.device)
    trees = []
    for r in range(rounds):
        g, h = obj.grad_hess(m)
        if fault == "half":
            g, h = g * keep, h * keep
        tree, row_out = ref.build_tree(bins, g, h, R.num_cuts, p, R.num_bins)
        depth = tree_depth(tree)
        if fault == "altered":
            lv = np.where(tree["is_leaf"], np.abs(tree["leaf_value"]), -1.0)
            s = int(np.argmax(lv))
            tree["leaf_value"][s] = -tree["leaf_value"][s]
            values = torch.as_tensor(tree["leaf_value"], device=R.device).to(dtype)
            row_out = values[ref.leaf_of_rows(bins, tree, R.num_bins, depth)]
        trees.append(tree)
        if not (fault == "unchanged" and r == 1):
            m = m + row_out
        values = torch.as_tensor(tree["leaf_value"], device=R.device).to(dtype)
        mv = mv + values[ref.leaf_of_rows(valid_bins, tree, R.num_bins, depth)]
    return Program(cuts, bins.cpu().numpy(), valid_bins.cpu().numpy(), trees,
                   m.float().cpu().numpy(), mv.float().cpu().numpy())
