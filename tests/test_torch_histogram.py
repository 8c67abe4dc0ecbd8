"""Port parity: the histogram functions and their tiling.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX package's ``flat`` lowering and against its Pallas
kernels in interpret mode. The CUDA kernels themselves are compared with
the plain versions by the ``cuda``-marked tests (skipped without a GPU) and
by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sagemaker_xgboost_container_tpu.ops import histogram as jax_hist
from sagemaker_xgboost_container_tpu_torch.ops import histogram as hist


@pytest.fixture
def problem():
    rng = np.random.RandomState(7)
    n, d, num_bins = 3000, 9, 33  # num_bins includes the missing slot
    bins = rng.randint(0, num_bins, size=(n, d)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    hess = (rng.rand(n) + 0.1).astype(np.float32)
    return bins, grad, hess, num_bins


def _node_local(n, W, seed=8):
    # dead rows (-1) mixed in, like a level after some nodes leafed
    return np.random.RandomState(seed).randint(-1, W, size=n).astype(np.int32)


def _pallas_knobs():
    return jax_hist.resolve_hist_knobs()._replace(
        impl="pallas", totals_impl="pallas", pallas_block=256
    )


def _port_hist(bins, grad, hess, node, W, B, bin_dtype=None):
    b = torch.as_tensor(bins if bin_dtype is None else bins.astype(bin_dtype))
    G, H = hist.level_histogram(
        b, torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(node), W, B
    )
    return G.numpy(), H.numpy()


@pytest.mark.parametrize("W", [1, 4, 16])
@pytest.mark.parametrize("bin_dtype", [np.uint8, np.uint16, np.int32])
def test_level_histogram_matches_jax_flat(problem, W, bin_dtype):
    bins, grad, hess, B = problem
    node = _node_local(len(grad), W)
    G, H = _port_hist(bins, grad, hess, node, W, B, bin_dtype)
    rG, rH = jax_hist._hist_flat(
        jnp.asarray(bins.astype(np.int32)), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(node), W, B,
    )
    np.testing.assert_allclose(G, np.asarray(rG), atol=1e-4)
    np.testing.assert_allclose(H, np.asarray(rH), atol=1e-4)


@pytest.mark.parametrize("W", [1, 8])
def test_level_histogram_matches_jax_pallas_interpret(problem, W):
    bins, grad, hess, B = problem
    node = _node_local(len(grad), W)
    G, H = _port_hist(bins, grad, hess, node, W, B)
    rG, rH = jax_hist.level_histogram(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(node),
        W, B, knobs=_pallas_knobs(),
    )
    # the Pallas kernel multiplies bf16x2 operands: ~16 mantissa bits
    np.testing.assert_allclose(G, np.asarray(rG), atol=5e-4)
    np.testing.assert_allclose(H, np.asarray(rH), atol=5e-4)


# W >= 8 keeps each total below ~250, where 1e-4 is a few f32 ulps (one
# node holding all 3000 rows sums to ~900, whose ulp is already 6e-5)
@pytest.mark.parametrize("W", [8, 64, 256])
def test_node_totals_matches_jax_pallas_interpret(problem, W):
    _, grad, hess, _ = problem
    node = _node_local(len(grad), W, seed=9)
    g, h = hist.node_totals(
        torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(node), W
    )
    rg, rh = jax_hist.node_totals(
        jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(node), W,
        knobs=_pallas_knobs(),
    )
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=1e-4)


def test_empty_rows_give_zero_histograms():
    bins = torch.zeros((0, 4), dtype=torch.uint16)
    empty = torch.zeros(0)
    node = torch.zeros(0, dtype=torch.int32)
    G, H = hist.level_histogram(bins, empty, empty, node, 2, 9)
    assert G.shape == (2, 4, 9) and not G.any() and not H.any()
    g, h = hist.node_totals(empty, empty, node, 3)
    assert g.shape == (3,) and not g.any() and not h.any()


def _class_problem(C=3, W=8, seed=21):
    rng = np.random.RandomState(seed)
    n, d, B = 3000, 9, 33
    bins = rng.randint(0, B, size=(n, d)).astype(np.uint8)
    grad = rng.randn(C, n).astype(np.float32)
    hess = (rng.rand(C, n) + 0.1).astype(np.float32)
    node = np.stack([_node_local(n, W, seed=seed + c) for c in range(C)])
    return bins, grad, hess, node, B


@pytest.mark.parametrize("W", [1, 8])
@pytest.mark.parametrize("bin_dtype", [np.uint8, np.uint16, np.int32])
def test_class_axis_equals_single_class_calls_bitwise(W, bin_dtype):
    bins, grad, hess, node, B = _class_problem(W=W)
    node[2, :] = -1  # a class with no active row
    b = torch.as_tensor(bins.astype(bin_dtype))
    G, H = hist.level_histogram(b, torch.as_tensor(grad), torch.as_tensor(hess),
                                torch.as_tensor(node), W, B)
    g, h = hist.node_totals(torch.as_tensor(grad), torch.as_tensor(hess),
                            torch.as_tensor(node), W)
    assert G.shape == (3, W, 9, B) and g.shape == (3, W)
    for c in range(3):
        Gc, Hc = hist.level_histogram(b, torch.as_tensor(grad[c]), torch.as_tensor(hess[c]),
                                      torch.as_tensor(node[c]), W, B)
        gc, hc = hist.node_totals(torch.as_tensor(grad[c]), torch.as_tensor(hess[c]),
                                  torch.as_tensor(node[c]), W)
        assert torch.equal(G[c], Gc) and torch.equal(H[c], Hc)
        assert torch.equal(g[c], gc) and torch.equal(h[c], hc)
    assert not G[2].any() and not g[2].any()


@pytest.mark.parametrize("impl", ["flat", "pallas"])
def test_class_axis_matches_jax_vmap(impl):
    import jax

    bins, grad, hess, node, B = _class_problem()
    W = 8
    knobs = jax_hist.resolve_hist_knobs()._replace(
        impl=impl, totals_impl="segment" if impl == "flat" else "pallas", pallas_block=256)
    rG, rH = jax.vmap(lambda g, h, nd: jax_hist.level_histogram(
        jnp.asarray(bins), g, h, nd, W, B, knobs=knobs))(
        jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(node))
    rg, rh = jax.vmap(lambda g, h, nd: jax_hist.node_totals(g, h, nd, W, knobs=knobs))(
        jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(node))
    G, H = _port_hist(bins, grad, hess, node, W, B)
    g, h = (t.numpy() for t in hist.node_totals(
        torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(node), W))
    for ours, ref in ((G, rG), (H, rH), (g, rg), (h, rh)):
        ref = np.asarray(ref)
        assert ours.shape == ref.shape
        # 1e-4 of the largest cell: f32 sums in another order (and, for the
        # Pallas kernel, bf16x2 operands of ~16 mantissa bits)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize(
    "n,d,W,B,C",
    [
        (1_000_000, 28, 1, 257, 1),
        (1_000_000, 28, 64, 257, 1),
        (1_000_000, 28, 128, 257, 1),
        (1_000_003, 28, 128, 256, 1),
        (0, 28, 4, 257, 1),
        (12_345, 5, 3, 33, 1),
        (100, 1, 1, 2, 1),
        (50_000, 300, 130, 257, 1),
        # CoverType's shape at levels 0 and 7 (subtracted: 64 left children)
        (581_012, 54, 1, 257, 7),
        (581_012, 54, 64, 257, 7),
        (10, 3, 4, 9, 3),
        # exact binning's data-sized u16 widths: one feature a CTA up to
        # 12,672 bins, bin tiles beyond, up to every width u16 bins hold
        (1_000_000, 28, 64, 5_000, 1),
        (1_000_000, 28, 64, 8_193, 1),
        (1_000_000, 28, 64, 12_672, 1),
        (1_000_000, 28, 64, 12_673, 1),
        (1_000_000, 28, 64, 20_001, 1),
        (100_000, 9, 16, 65_536, 1),
        (250_000, 28, 16, 20_001, 5),
    ],
)
def test_hist_plan_covers_the_grid(n, d, W, B, C):
    p = hist.hist_plan(n, d, W, B, num_sms=132, classes=C)
    n, W = C * n, C * W  # the kernels see C*n entries and C*W keys
    # hist_kernel: one CTA's histogram slice fits the budget, and the
    # feature tiles cover d and the bin tiles B without an empty tile
    assert p.smem_bytes == p.feature_tile * 2 * p.bin_tile * 4
    assert p.smem_bytes <= hist.HIST_SMEM_BUDGET
    assert p.feature_tile * p.feature_tiles >= d
    assert (p.feature_tiles - 1) * p.feature_tile < d
    assert p.bin_tile * p.bin_tiles >= B
    assert (p.bin_tiles - 1) * p.bin_tile < B
    # the whole row of bins in one tile wherever it fits the budget
    assert (p.bin_tiles == 1) == (2 * B * 4 <= hist.HIST_SMEM_BUDGET)
    if p.bin_tiles > 1:
        assert p.feature_tile == 1 and p.feature_tiles == d
    # a persistent grid of about two CTAs per SM, and one scratch piece per
    # CTA plus one per node
    tiles = p.feature_tiles * p.bin_tiles
    assert p.ctas * tiles <= 2 * 132 + tiles
    assert p.ctas >= 1 and p.slots == p.ctas + W
    # hist_count / hist_scatter chunks cover the rows
    assert p.count_ctas * p.rows_per_count_cta >= n
    assert (p.count_ctas - 1) * p.rows_per_count_cta < max(n, 1)


@pytest.mark.parametrize(
    "n,d,W,B,C",
    [
        (10, 1, 1, 0, 1),                        # no bins
        (10, 1, hist.HIST_MAX_NODES + 1, 9, 1),  # node counters beyond shared memory
        (2**31, 1, 1, 9, 1),                     # row ids beyond int32
        (10, 1, hist.HIST_MAX_NODES // 4 + 1, 9, 4),  # C*W keys beyond shared memory
        (2**29, 1, 1, 9, 4),                     # C*n entry ids beyond int32
        (10, 1, 1, 9, 0),
    ],
)
def test_hist_plan_rejects_bins_beyond_shared_memory(n, d, W, B, C):
    with pytest.raises(ValueError):
        hist.hist_plan(n, d, W, B, num_sms=132, classes=C)


def _node_distribution(kind, n, W, seed=11):
    rng = np.random.RandomState(seed)
    if kind == "random":       # dead rows (-1) mixed in
        return rng.randint(-1, W, size=n).astype(np.int32)
    if kind == "left":         # a subtracted level's left children: half dead
        child = rng.randint(0, 2 * W, size=n)
        return np.where(child % 2 == 0, child // 2, -1).astype(np.int32)
    if kind == "one":          # every row in one node
        return np.full(n, W // 2, dtype=np.int32)
    if kind == "half_empty":   # odd nodes hold no rows
        return (2 * rng.randint(0, (W + 1) // 2, size=n)).astype(np.int32)
    if kind == "none":         # no row active (below 0 or at W and beyond)
        return np.where(rng.rand(n) < 0.5, -1, W + rng.randint(0, 3, size=n)).astype(np.int32)
    raise ValueError(kind)


def _class_nodes(kind, n, W, C, seed=11):
    """[n] node ids (C = 1), or [C, n] with each class drawn on its own;
    "class_empty" leaves the last class without an active row."""
    if C == 1:
        return _node_distribution(kind, n, W, seed)
    if kind == "class_empty":
        return np.stack([_node_distribution("random", n, W, seed + c) for c in range(C - 1)]
                        + [_node_distribution("none", n, W, seed)])
    return np.stack([_node_distribution(kind, n, W, seed + c) for c in range(C)])


def _fold_keys(node, W):
    """[n] or [C, n] node ids -> the kernels' view: per entry of the C*n
    (class-major), its key class * W + node, or -1 when inactive."""
    node = np.atleast_2d(node)
    C, n = node.shape
    active = (node >= 0) & (node < W)
    keys = np.where(active, np.arange(C)[:, None] * W + node, -1)
    return keys.reshape(-1), C, n


def _emulate_hist_kernels(bins, grad, hess, node, W, B, plan):
    """The hist_* kernels' index arithmetic, step by step in numpy, over the
    C*n entries of [C, n] inputs (or n of [n]) with the class folded into
    the key: per-chunk counts, their scans, the scatter into key order, the
    equal slices of the persistent CTAs with their (c + k) pieces (each
    segment reading the bin rows of its key's class), and the reduce over
    the CTAs whose slices overlap each key. Checks that no piece slot is
    written twice and that the reduce reads exactly the pieces written.
    Returns [K, d, B] histograms, K = C*W."""
    d = bins.shape[1]
    key, classes, n = _fold_keys(node, W)
    grad, hess = np.ravel(grad), np.ravel(hess)
    entries, K = len(key), classes * W
    C, R = plan.count_ctas, plan.rows_per_count_cta
    counts = np.zeros((K, C), dtype=np.int64)
    for c in range(C):
        seg = key[c * R:(c + 1) * R]
        counts[:, c] = np.bincount(seg[seg >= 0], minlength=K)
    base = np.cumsum(counts, axis=1) - counts
    totals = counts.sum(axis=1)
    offsets = np.concatenate([[0], np.cumsum(totals)])
    order = np.full(int(offsets[K]), -1, dtype=np.int64)
    for c in range(C):
        cursor = offsets[:K] + base[:, c]
        for e in range(c * R, min(entries, (c + 1) * R)):
            if key[e] >= 0:
                order[cursor[key[e]]] = e
                cursor[key[e]] += 1
    assert (order >= 0).all() and len(np.unique(order)) == len(order)

    total, P = int(offsets[K]), plan.ctas
    S = -(-total // P)
    pieces = {}
    for c in range(P):
        lo, hi = c * S, min(total, (c + 1) * S)
        if lo >= hi:
            continue
        w = int(np.searchsorted(offsets, lo, side="right")) - 1
        while lo < hi:
            seg_end = min(hi, int(offsets[w + 1]))
            seg = order[lo:seg_end]
            rows = seg - (w // W) * n  # the class's entries start at class * n
            assert ((rows >= 0) & (rows < n)).all()
            slot = c + w
            assert slot < plan.slots and slot not in pieces
            g = np.zeros((d, B), np.float64)
            h = np.zeros((d, B), np.float64)
            # the bin tiles' CTAs of slice c: each adds the entries whose
            # bin lies in its tile and writes only its tile's cells
            written = np.zeros((d, B), np.int64)
            for z in range(plan.bin_tiles):
                b0 = z * plan.bin_tile
                nb = min(plan.bin_tile, B - b0)
                for f in range(d):
                    b = bins[rows, f].astype(np.int64)
                    m = (b >= b0) & (b < b0 + nb)
                    np.add.at(g[f], b[m], grad[seg][m])
                    np.add.at(h[f], b[m], hess[seg][m])
                    written[f, b0:b0 + nb] += 1
            assert (written == 1).all()
            pieces[slot] = (c, w, g, h)
            lo = seg_end
            if lo < hi:
                w += 1
                while offsets[w + 1] <= lo:
                    w += 1
    G = np.zeros((K, d, B))
    H = np.zeros((K, d, B))
    read = set()
    for w in range(K):
        a, e = int(offsets[w]), int(offsets[w + 1])
        if e > a:
            for c in range(a // S, (e - 1) // S + 1):
                cw, ww, g, h = pieces[c + w]
                assert (cw, ww) == (c, w)
                G[w] += g
                H[w] += h
                read.add(c + w)
    assert read == set(pieces)
    return G, H


@pytest.mark.parametrize(
    "n,W,kind,C",
    [
        (5000, 1, "random", 1),
        (5000, 16, "left", 1),
        (5000, 16, "one", 1),
        (5000, 16, "half_empty", 1),
        (5000, 16, "none", 1),
        (40, 8, "random", 1),     # fewer rows than hist_kernel CTAs
        (3000, 130, "random", 1),
        (0, 4, "random", 1),
        # the class axis: C*n entries, C*W keys
        (3000, 16, "left", 3),
        (3000, 1, "random", 3),
        (12, 8, "random", 3),     # fewer entries than hist_kernel CTAs
        (2000, 16, "class_empty", 2),
        (0, 4, "random", 3),
    ],
)
def test_hist_kernel_bookkeeping_matches_plain(n, W, kind, C):
    rng = np.random.RandomState(3)
    d, B = 3, 7
    bins = rng.randint(0, B, size=(n, d)).astype(np.uint8)
    shape = (n,) if C == 1 else (C, n)
    grad = rng.randn(*shape).astype(np.float32)
    hess = (rng.rand(*shape) + 0.1).astype(np.float32)
    node = _class_nodes(kind, n, W, C)
    plan = hist.hist_plan(n, d, W, B, num_sms=32, classes=C)
    if kind == "random" and n * C < 40:
        assert n * C < plan.ctas
    G, H = _emulate_hist_kernels(bins, grad, hess, node, W, B, plan)
    Gp, Hp = _port_hist(bins, grad, hess, node, W, B)
    Gp, Hp = Gp.reshape(C * W, d, B), Hp.reshape(C * W, d, B)
    # f64 pieces against an f32 sum: 1e-4 of the largest cell, as on the card
    tol = 1e-4 * max(1.0, np.abs(Gp).max(initial=0), np.abs(Hp).max(initial=0))
    np.testing.assert_allclose(G, Gp, atol=tol, rtol=0)
    np.testing.assert_allclose(H, Hp, atol=tol, rtol=0)


@pytest.mark.parametrize("n,d,W,B,C", [
    (300, 2, 4, 20_001, 1),    # two bin tiles
    (200, 1, 2, 65_536, 1),    # every width u16 bins hold: six tiles
    (150, 2, 3, 12_673, 2),    # the class axis, one bin past one tile
])
def test_hist_kernel_bin_tiles_match_plain(n, d, W, B, C):
    """Bins wider than one CTA's shared memory: the tiles' CTAs together add
    every entry once, into the cells of its bin."""
    rng = np.random.RandomState(5)
    bins = rng.randint(0, B, size=(n, d)).astype(np.uint16)
    bins[rng.rand(n, d) < 0.1] = B - 1   # the missing bin, in the last tile
    shape = (n,) if C == 1 else (C, n)
    grad = rng.randn(*shape).astype(np.float32)
    hess = (rng.rand(*shape) + 0.1).astype(np.float32)
    node = _class_nodes("random", n, W, C)
    plan = hist.hist_plan(n, d, W, B, num_sms=4, classes=C)
    assert plan.bin_tiles > 1
    G, H = _emulate_hist_kernels(bins, grad, hess, node, W, B, plan)
    Gp, Hp = _port_hist(bins, grad, hess, node, W, B)
    Gp, Hp = Gp.reshape(C * W, d, B), Hp.reshape(C * W, d, B)
    tol = 1e-4 * max(1.0, np.abs(Gp).max(initial=0), np.abs(Hp).max(initial=0))
    np.testing.assert_allclose(G, Gp, atol=tol, rtol=0)
    np.testing.assert_allclose(H, Hp, atol=tol, rtol=0)


@pytest.mark.parametrize(
    "n,W",
    [
        (1_000_000, 1),
        (1_000_000, 256),
        (1_000_000, 4096),
        (1_000_000, hist.TOTALS_MAX_NODES),
        (0, 256),
        (100, 256),        # fewer rows than CTAs
        (1_000_003, 256),  # an unaligned n
        (581_012, 7 * 256),  # CoverType's last level, C=7 (below, as C*n, C*W)
    ],
)
def test_totals_plan_covers_the_rows(n, W):
    if W == 7 * 256:
        p = hist.totals_plan(n, 256, num_sms=132, classes=7)
        n *= 7
        assert (p.warps_per_cta, p.ctas) == (8, 264)
    else:
        p = hist.totals_plan(n, W, num_sms=132)
    # every warp has its own [2W] f32 copy, within the budget
    assert 1 <= p.warps_per_cta <= 8
    assert p.smem_bytes == p.warps_per_cta * 8 * W <= hist.TOTALS_SMEM_BUDGET
    if W == 256:
        assert (p.warps_per_cta, p.smem_bytes) == (8, 16 * 1024)
    # a persistent grid: as many CTAs per SM as their shared memory (and 1
    # KB reserved for each) lets reside, from 1 up to 4
    per_sm = p.ctas // 132
    assert p.ctas == per_sm * 132 and 1 <= per_sm <= 4
    assert per_sm == 1 or per_sm * (p.smem_bytes + 1024) <= 228 * 1024
    if per_sm < 4:
        assert (per_sm + 1) * (p.smem_bytes + 1024) > 228 * 1024
    if W == 256:
        assert per_sm == 4
    # equal slices that cover n, the shortest that do (below ctas rows, the
    # last CTAs' slices are empty)
    assert p.ctas * p.rows_per_cta >= n
    assert p.ctas * (p.rows_per_cta - 1) < max(n, 1)
    assert p.piece_floats == p.ctas * 2 * W


@pytest.mark.parametrize("n,W,C", [
    (1000, 0, 1), (1000, hist.TOTALS_MAX_NODES + 1, 1),
    (1000, hist.TOTALS_MAX_NODES // 7 + 1, 7),  # C*W keys beyond shared memory
    (2**29, 1, 4),                              # C*n entry ids beyond int32
])
def test_totals_plan_rejects_widths_beyond_shared_memory(n, W, C):
    assert hist.TOTALS_MAX_NODES == 29056
    with pytest.raises(ValueError):
        hist.totals_plan(n, W, num_sms=132, classes=C)


_TOTALS_ROW_UNROLL = 4       # kRowUnroll in csrc/totals_kernel.cu
_TOTALS_REDUCE_GROUPS = 16   # kReduceGroups there


def _lowest_lane(mask):
    return (mask & -mask).bit_length() - 1


def _emulate_reduce_peers(peers, g, h):
    """reduce_peers of csrc/totals_kernel.cu on one warp, in f32: peers[l]
    is the lane mask of lane l's group; each group's sum lands on its
    lowest lane, in the kernel's order of additions."""
    rel = [bin(peers[l] & ((1 << l) - 1)).count("1") for l in range(32)]
    rest = [peers[l] & (0xFFFFFFFE << l) & 0xFFFFFFFF for l in range(32)]
    g, h = g.copy(), h.copy()
    while any(rest):
        src = [_lowest_lane(r) if r else 31 for r in rest]
        tg, th = g[src], h[src]  # every lane shuffles the old values
        take = np.array([r != 0 for r in rest])
        g = np.where(take, g + tg, g).astype(np.float32)
        h = np.where(take, h + th, h).astype(np.float32)
        done = sum(1 << l for l in range(32) if rel[l] & 1)
        rest = [r & ~done for r in rest]
        rel = [x >> 1 for x in rel]
    return g, h


def _emulate_totals_kernels(grad, hess, node, W, plan):
    """The totals_* kernels' index arithmetic and order of additions, in
    f32 numpy, over the C*n entries of [C, n] inputs (or n of [n]) with the
    class folded into the key: each CTA's equal slice, each warp's groups of
    32 entries with their peer sums and one leader per key, the warp-private
    copies summed in warp order into the CTA's piece, and the pieces summed
    in runs of consecutive CTAs, the runs' sums in run order. Checks that
    every entry is read exactly once and every piece written and read once.
    Returns the [K] g and h totals, K = C*W."""
    keys, classes, _ = _fold_keys(node, W)
    grad, hess = np.ravel(grad), np.ravel(hess)
    K = classes * W
    n, W2, U = len(keys), 2 * K, _TOTALS_ROW_UNROLL
    S, warps = plan.rows_per_cta, plan.warps_per_cta
    seen = np.zeros(n, dtype=np.int64)
    pieces = np.full((plan.ctas, W2), np.nan, dtype=np.float32)
    lanes = np.arange(32)
    for c in range(plan.ctas):
        r0 = c * S
        r1 = min(n, r0 + S)
        acc = np.zeros((warps, W2), dtype=np.float32)
        for w in range(warps):
            for base in range(r0 + 32 * U * w, r1, 32 * U * warps):
                for u in range(U):
                    rows = base + 32 * u + lanes
                    valid = rows < r1
                    seen[rows[valid]] += 1
                    at = np.where(valid, rows, 0)
                    key = np.where(valid, keys[at], -1)
                    g = np.where(key >= 0, grad[at], 0).astype(np.float32)
                    h = np.where(key >= 0, hess[at], 0).astype(np.float32)
                    peers = [int(np.sum((key == key[l]) << lanes)) for l in range(32)]
                    g, h = _emulate_reduce_peers(peers, g, h)
                    leaders = [l for l in range(32) if key[l] >= 0 and _lowest_lane(peers[l]) == l]
                    assert len({int(key[l]) for l in leaders}) == len(leaders)
                    for l in leaders:
                        acc[w, key[l]] += g[l]
                        acc[w, K + key[l]] += h[l]
        pieces[c] = acc[0]
        for w in range(1, warps):
            pieces[c] += acc[w]
    assert (seen == 1).all()
    assert not np.isnan(pieces).any()
    run = -(-plan.ctas // _TOTALS_REDUCE_GROUPS)
    runs = np.zeros((_TOTALS_REDUCE_GROUPS, W2), dtype=np.float32)
    read = []
    for r in range(_TOTALS_REDUCE_GROUPS):
        for c in range(r * run, min(plan.ctas, (r + 1) * run)):
            runs[r] += pieces[c]
            read.append(c)
    assert read == list(range(plan.ctas))
    out = runs[0].copy()
    for r in range(1, _TOTALS_REDUCE_GROUPS):
        out += runs[r]
    return out[:K], out[K:]


@pytest.mark.parametrize(
    "n,W,kind,C",
    [
        (5000, 1, "random", 1),
        (5000, 16, "random", 1),
        (5000, 256, "random", 1),
        (5000, 16, "one", 1),
        (5000, 16, "half_empty", 1),
        (5000, 16, "none", 1),
        (30, 8, "random", 1),     # fewer rows than totals_partial CTAs
        (0, 4, "random", 1),
        (3000, 4096, "random", 1),  # seven warps of a CTA, one CTA an SM
        # the class axis: C*n entries, C*W keys
        (3000, 256, "random", 3),
        (3000, 1, "random", 3),
        (2000, 16, "class_empty", 2),
        (10, 8, "random", 3),     # fewer entries than totals_partial CTAs
    ],
)
def test_totals_kernel_bookkeeping_matches_plain(n, W, kind, C):
    rng = np.random.RandomState(5)
    shape = (n,) if C == 1 else (C, n)
    grad = rng.randn(*shape).astype(np.float32)
    hess = (rng.rand(*shape) + 0.1).astype(np.float32)
    node = _class_nodes(kind, n, W, C)
    # 10 SMs: 40 CTAs at W <= 256, so the reduce's last runs are empty
    plan = hist.totals_plan(n, W, num_sms=10, classes=C)
    if n * C < 40:
        assert n * C < plan.ctas
    if W == 4096:
        assert (plan.warps_per_cta, plan.ctas) == (7, 10)
    g, h = _emulate_totals_kernels(grad, hess, node, W, plan)
    gp, hp = (t.numpy().reshape(-1) for t in hist.node_totals(
        torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(node), W))
    # f32 sums in another order: 1e-4 of the largest total, as on the card
    tol = 1e-4 * max(1.0, np.abs(gp).max(initial=0), np.abs(hp).max(initial=0))
    np.testing.assert_allclose(g, gp, atol=tol, rtol=0)
    np.testing.assert_allclose(h, hp, atol=tol, rtol=0)
    # integer-valued weights sum exactly in any order
    ones = np.ones(shape, dtype=np.float32)
    ints = rng.randint(0, 4, shape).astype(np.float32)
    ge, he = _emulate_totals_kernels(ones, ints, node, W, plan)
    gq, hq = (t.numpy().reshape(-1) for t in hist.node_totals(
        torch.as_tensor(ones), torch.as_tensor(ints), torch.as_tensor(node), W))
    np.testing.assert_array_equal(ge, gq)
    np.testing.assert_array_equal(he, hq)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, 2), dtype=torch.uint8, device="meta")
    v = torch.empty(4, device="meta")
    node = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        hist.level_histogram(meta, v, v, node, 1, 9)
    with pytest.raises(ValueError):
        hist.node_totals(v, v, node, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "W,dtype,kind",
    [
        (1, np.uint16, "random"),
        (8, np.uint8, "random"),
        (130, np.uint16, "random"),
        (64, np.uint16, "left"),
        (64, np.uint16, "one"),
        (64, np.uint16, "half_empty"),
        (64, np.uint16, "none"),
        (4, np.int32, "random"),
    ],
)
def test_hist_kernel_matches_plain(problem, cuda_device, W, dtype, kind):
    bins, grad, hess, B = problem
    node = _node_distribution(kind, len(grad), W)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (bins.astype(dtype), grad, hess, node)]
    hist.reset_launch_counts()
    G, H = hist.level_histogram(*args, W, B)
    assert hist.LAUNCHES["hist_kernel"] == 1
    Gp, Hp = hist._hist_plain(*args, W, B)
    torch.testing.assert_close(G, Gp, atol=1e-4, rtol=0)
    torch.testing.assert_close(H, Hp, atol=1e-4, rtol=0)
    # integer weights sum exactly in f32, in any order
    ones = torch.ones_like(args[1])
    Ge, He = hist.level_histogram(args[0], ones, ones, args[3], W, B)
    Gq, Hq = hist._hist_plain(args[0], ones, ones, args[3], W, B)
    assert torch.equal(Ge, Gq) and torch.equal(He, Hq)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,W,kind",
    [
        (3000, 1, "random"),
        (3000, 256, "random"),
        (3000, 4096, "random"),
        (3000, 64, "one"),
        (3000, 64, "none"),
        (100, 256, "random"),  # fewer rows than totals_partial CTAs
        (0, 256, "random"),
    ],
)
def test_totals_kernel_matches_plain(problem, cuda_device, n, W, kind):
    _, grad, hess, _ = problem
    node = _node_distribution(kind, n, W)
    args = [torch.as_tensor(a[:n], device=cuda_device) for a in (grad, hess)]
    args.append(torch.as_tensor(node, device=cuda_device))
    hist.reset_launch_counts()
    g, h = hist.node_totals(*args, W)
    assert hist.LAUNCHES["totals_kernel"] == 1
    gp, hp = hist._totals_plain(*args, W)
    tol = 1e-4 * max(1.0, float(gp.abs().max()) if n else 0.0,
                     float(hp.abs().max()) if n else 0.0)
    torch.testing.assert_close(g, gp, atol=tol, rtol=0)
    torch.testing.assert_close(h, hp, atol=tol, rtol=0)
    # the order of additions is fixed: a second call is bitwise equal
    g2, h2 = hist.node_totals(*args, W)
    assert torch.equal(g, g2) and torch.equal(h, h2)
    # integer-valued weights sum exactly in any order
    ones = torch.ones_like(args[0])
    ints = torch.as_tensor(
        np.random.RandomState(4).randint(0, 4, n).astype(np.float32), device=cuda_device)
    ge, he = hist.node_totals(ones, ints, args[2], W)
    gq, hq = hist._totals_plain(ones, ints, args[2], W)
    assert torch.equal(ge, gq) and torch.equal(he, hq)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "W,C,dtype,kind",
    [
        (64, 7, np.uint16, "random"),
        (1, 7, np.uint16, "random"),
        (16, 2, np.uint8, "class_empty"),
        (8, 3, np.int32, "left"),
    ],
)
def test_hist_kernel_class_axis_matches_plain(problem, cuda_device, W, C, dtype, kind):
    bins, _, _, B = problem
    n = len(bins)
    rng = np.random.RandomState(13)
    grad = rng.randn(C, n).astype(np.float32)
    hess = (rng.rand(C, n) + 0.1).astype(np.float32)
    node = _class_nodes(kind, n, W, C)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (bins.astype(dtype), grad, hess, node)]
    hist.reset_launch_counts()
    G, H = hist.level_histogram(*args, W, B)
    assert hist.LAUNCHES["hist_kernel"] == 1 and G.shape == (C, W, bins.shape[1], B)
    Gp, Hp = hist._hist_plain(*args, W, B)
    tol = 1e-4 * max(1.0, float(Gp.abs().max()), float(Hp.abs().max()))
    torch.testing.assert_close(G, Gp, atol=tol, rtol=0)
    torch.testing.assert_close(H, Hp, atol=tol, rtol=0)
    ones = torch.ones_like(args[1])
    Ge, He = hist.level_histogram(args[0], ones, ones, args[3], W, B)
    Gq, Hq = hist._hist_plain(args[0], ones, ones, args[3], W, B)
    assert torch.equal(Ge, Gq) and torch.equal(He, Hq)


@pytest.mark.cuda
@pytest.mark.parametrize("W,C,kind", [(256, 7, "random"), (1, 7, "random"),
                                      (16, 2, "class_empty"), (8, 3, "one")])
def test_totals_kernel_class_axis_matches_plain(problem, cuda_device, W, C, kind):
    n = 3000
    rng = np.random.RandomState(17)
    args = [torch.as_tensor(a, device=cuda_device) for a in (
        rng.randn(C, n).astype(np.float32), (rng.rand(C, n) + 0.1).astype(np.float32),
        _class_nodes(kind, n, W, C))]
    hist.reset_launch_counts()
    g, h = hist.node_totals(*args, W)
    assert hist.LAUNCHES["totals_kernel"] == 1 and g.shape == (C, W)
    gp, hp = hist._totals_plain(*args, W)
    tol = 1e-4 * max(1.0, float(gp.abs().max()), float(hp.abs().max()))
    torch.testing.assert_close(g, gp, atol=tol, rtol=0)
    torch.testing.assert_close(h, hp, atol=tol, rtol=0)
    g2, h2 = hist.node_totals(*args, W)
    assert torch.equal(g, g2) and torch.equal(h, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,W", [(8_193, 64), (20_001, 16), (65_536, 4)])
def test_hist_kernel_wide_bins_on_cuda_match_plain(B, W):
    """hist_kernel at exact binning's widths, one feature a CTA (8,193) and
    bins tiled across CTAs (20,001 and 65,536), against the plain version;
    integer weights sum exactly, so those histograms are equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py phase 2 runs these on the card")
    rng = np.random.RandomState(B)
    n, d = 100_000, 5
    bins = torch.as_tensor(rng.randint(0, B, (n, d)).astype(np.uint16), device="cuda")
    node = torch.as_tensor(rng.randint(-1, W, n).astype(np.int32), device="cuda")
    ones = torch.ones(n, device="cuda")
    ints = torch.as_tensor(rng.randint(0, 4, n).astype(np.float32), device="cuda")
    G, H = hist.level_histogram(bins, ones, ints, node, W, B)
    Gp, Hp = hist._hist_plain(bins, ones, ints, node, W, B)
    assert torch.equal(G, Gp) and torch.equal(H, Hp)
