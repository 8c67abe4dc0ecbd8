"""Per-node gradient histograms: the hot op of the tree builder.

For each tree level, accumulate (grad, hess) into a (node x feature x bin)
tensor (``level_histogram``); at the last level only per-node totals are
needed (``node_totals``). Both take a class axis: C trees that share the
bins (one per class of a multiclass round) are one call, and one launch, on
``[C, n]`` gradients. On a CUDA tensor each function launches its
hand-written kernels (``csrc/hist_kernel.cu``, ``csrc/totals_kernel.cu``); on
a CPU tensor it runs its plain PyTorch version (``_hist_plain``,
``_totals_plain``). There is no fallback from one to the other.

The histogram kernels add in shared memory with f32 atomics, so the order of
the additions, and the last bits of every cell, vary from run to run. The
totals kernels use no atomics and sum in an order fixed by the shapes, so
their totals are the same on every call. Against a sequential f32 sum of the
same values either differs by a few ulps of the largest partial sum.
"""

import collections

import torch

# kernel launch counts, one per wrapper; chip_smoke.py resets and reads them
LAUNCHES = {"hist_kernel": 0, "totals_kernel": 0}
# the work of every call of the two wrappers, either route: bytes moved and
# f32 adds (``hist_work`` / ``totals_work``); the device plane's per-round
# cost is a difference of two readings (telemetry/device.py)
WORK = {"bytes": 0, "adds": 0}

# histogram cache a sibling-subtraction build may keep alive (both levels'
# G and H, f32): the same cap as the JAX package's default
SUBTRACT_MEM = 512 * 1024 * 1024

# shared memory one hist_kernel CTA may use for its (g, h) histogram slice:
# two CTAs of this size fit an H100 SM's 228 KB
HIST_SMEM_BUDGET = 99 * 1024
_HIST_CTAS_PER_SM = 2
# hist_count / hist_scatter: row chunks of at least this many rows
_HIST_MIN_CHUNK_ROWS = 2048
# hist_count, hist_scan and hist_scatter keep one int32 per node in shared
# memory, within the 227 KB a CTA can have
HIST_MAX_NODES = (227 * 1024) // 4
# row ids are int32
HIST_MAX_ROWS = 2**31 - 1

# shared memory of one totals_partial CTA: a private [2W] f32 copy per warp
TOTALS_SMEM_BUDGET = 227 * 1024
TOTALS_MAX_NODES = TOTALS_SMEM_BUDGET // 8  # 29056: one warp's copy fills it
_TOTALS_MAX_WARPS = 8
_TOTALS_MAX_CTAS_PER_SM = 4
# an H100 SM's shared memory, of which each resident CTA takes 1 KB more
_SM_SMEM_BYTES = 228 * 1024
_CTA_RESERVED_SMEM = 1024

HistPlan = collections.namedtuple(
    "HistPlan",
    [
        "ctas", "feature_tile", "feature_tiles",  # hist_kernel grid (x, y)
        "bin_tile", "bin_tiles",                  # and z: bins [z*bin_tile, ...)
        "smem_bytes",                             # its dynamic shared memory
        "slots",                                  # scratch pieces, ctas + W
        "count_ctas", "rows_per_count_cta",       # hist_count / hist_scatter
    ],
)

TotalsPlan = collections.namedtuple(
    "TotalsPlan",
    [
        "ctas", "warps_per_cta",  # totals_partial grid and block (x 32 threads)
        "smem_bytes",             # its dynamic shared memory
        "rows_per_cta",           # S: CTA c takes rows [c*S, (c+1)*S)
        "piece_floats",           # f32 scratch: one [2W] piece per CTA
    ],
)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def hist_work(n, d, W, B, C=1, bin_bytes=2):
    """(bytes, adds) of one ``level_histogram`` call, counted as
    ``chip_smoke.py``'s bound counts them: node ids read for every entry,
    (g, h) and the bins of the active rows, G and H written; two adds a
    feature an active entry. Every row counts as active: the node ids live
    on the card, and counting the active ones would cost a sync."""
    return (C * n * 4 + C * n * 8 + n * d * bin_bytes + 2 * C * W * d * B * 4,
            2 * C * n * d)


def totals_work(n, W, C=1):
    """(bytes, adds) of one ``node_totals`` call: (g, h, node) read for
    every entry, the [2, C, W] totals written, two adds an entry; every row
    counted active, as in ``hist_work``."""
    return C * n * 12 + 2 * C * W * 4, 2 * C * n


def _note_work(nbytes, adds):
    WORK["bytes"] += nbytes
    WORK["adds"] += adds


def subtraction_enabled(cache_bytes):
    """Memory cap on the histogram cache sibling subtraction keeps alive."""
    return cache_bytes <= SUBTRACT_MEM


def _cdiv(a, b):
    return -(-a // b)


def hist_plan(n, d, W, B, num_sms, classes=1):
    """Launch shapes of the hist_* kernels for one level_histogram call.

    With C = ``classes`` the kernels see C*n entries and K = C*W keys (the
    class folded into the key); below, "rows" are entries and "nodes" keys.

    hist_kernel holds [feature_tile, bin_tile] x (g, h) f32 in shared
    memory, within HIST_SMEM_BUDGET: the whole row where it fits (d=28,
    B=257: 57.6 KB), else feature tiles of equal width, and where one
    feature's B bins do not fit (B > 12,672: exact binning's wide u16 bins)
    one feature a CTA and bin tiles of equal width, each CTA adding only the
    entries whose bin falls in its tile. Its grid is persistent: ctas x
    feature_tiles x bin_tiles fills the card with _HIST_CTAS_PER_SM CTAs per
    SM, and each of the ctas CTAs takes an equal slice of the rows ordered
    by node. A CTA writes one scratch piece per node its slice touches, at
    slot c + w (its tile's cells of it), so ctas + K slots suffice.
    hist_count and hist_scatter split the rows into count_ctas chunks.
    """
    keys, entries = classes * W, classes * n
    if B < 1:
        raise ValueError("hist_kernel takes B >= 1, got {}".format(B))
    max_cells = HIST_SMEM_BUDGET // 8  # (g, h) f32 cells of one CTA
    bin_tiles = _cdiv(B, max_cells)
    bin_tile = _cdiv(B, bin_tiles)
    per_feature = 2 * bin_tile * 4
    max_features = HIST_SMEM_BUDGET // per_feature
    if classes < 1 or W < 1 or keys > HIST_MAX_NODES:
        raise ValueError("hist_kernel takes 1 <= C*W <= {}, got C={} W={}".format(
            HIST_MAX_NODES, classes, W))
    if entries > HIST_MAX_ROWS:
        raise ValueError("hist_kernel takes C*n <= {} entries, got C={} n={}".format(
            HIST_MAX_ROWS, classes, n))
    feature_tiles = max(1, _cdiv(d, max_features))
    feature_tile = _cdiv(d, feature_tiles)
    if feature_tiles > 65535:
        raise ValueError("hist_kernel: grid too large for d={}".format(d))
    ctas = max(1, _cdiv(_HIST_CTAS_PER_SM * num_sms, feature_tiles * bin_tiles))
    count_ctas = max(1, min(_HIST_CTAS_PER_SM * num_sms,
                            _cdiv(entries, _HIST_MIN_CHUNK_ROWS)))
    rows_per_count_cta = max(1, _cdiv(entries, count_ctas))
    return HistPlan(
        ctas, feature_tile, feature_tiles, bin_tile, bin_tiles,
        feature_tile * per_feature, ctas + keys, count_ctas, rows_per_count_cta,
    )


def totals_plan(n, W, num_sms, classes=1):
    """Launch shapes of the totals_* kernels for one node_totals call.

    With C = ``classes`` the kernels see C*n entries and K = C*W keys (the
    class folded into the key); below, "rows" are entries and W stands for
    K. Every warp keeps its own [2W] f32 copy in shared memory, so a CTA has as
    many warps (up to 8) as copies fit TOTALS_SMEM_BUDGET: 8 at W=256 (16
    KB), 1 at W=TOTALS_MAX_NODES. totals_partial is a persistent grid of as
    many such CTAs per SM as fit its shared memory, up to 4 (32 warps to
    keep rows in flight), each over an equal slice of the rows; an empty
    slice gives a zero piece.
    """
    if classes < 1 or not 1 <= W <= TOTALS_MAX_NODES // classes:
        raise ValueError("totals_kernel takes 1 <= C*W <= {}, got C={} W={}".format(
            TOTALS_MAX_NODES, classes, W))
    if classes > 1 and classes * n > HIST_MAX_ROWS:
        # the class of an entry comes from a 32-bit division of its id
        raise ValueError("totals_kernel takes C*n <= {} entries, got C={} n={}".format(
            HIST_MAX_ROWS, classes, n))
    keys = classes * W
    warps = min(_TOTALS_MAX_WARPS, TOTALS_SMEM_BUDGET // (8 * keys))
    smem = warps * 8 * keys
    per_sm = _SM_SMEM_BYTES // (smem + _CTA_RESERVED_SMEM)
    ctas = max(1, min(_TOTALS_MAX_CTAS_PER_SM, per_sm)) * num_sms
    return TotalsPlan(ctas, warps, smem, _cdiv(classes * n, ctas), ctas * 2 * keys)


def widen_rows(bins, rows=None):
    """Bin indices (of the rows ``rows``, or all) as int64. uint16 has few
    torch ops, so it is indexed as int16 and masked back."""
    if bins.dtype == torch.uint16:
        b = bins.view(torch.int16)
        b = b if rows is None else b.index_select(0, rows)
        return b.long() & 0xFFFF
    b = bins if rows is None else bins.index_select(0, rows)
    return b.long()


def level_histogram(bins, grad, hess, node_local, num_nodes, num_bins):
    """Build (G, H) histograms for one tree level.

    Args:
      bins: [n, d] uint8/uint16/int32 bin indices (missing bin included).
      grad, hess: f32 [n], or [C, n] for C classes sharing the bins.
      node_local: i32, shaped as grad; position of the row's node within
        this level (per class), or negative when the row no longer
        participates.
      num_nodes: number of nodes W at this level (per class).
      num_bins: histogram width B per feature (max_bin + 1).

    Returns:
      (G, H): f32 [num_nodes, d, num_bins], or [C, num_nodes, d, num_bins].
    """
    n, d = bins.shape
    _note_work(*hist_work(n, d, num_nodes, num_bins, grad.shape[0] if grad.dim() == 2 else 1,
                          bins.element_size()))
    if bins.device.type == "cpu":
        return _hist_plain(bins, grad, hess, node_local, num_nodes, num_bins)
    return _hist_cuda(bins, grad, hess, node_local, num_nodes, num_bins)


def node_totals(grad, hess, node_local, num_nodes):
    """Per-node (sum g, sum h) over rows with node_local in [0, num_nodes),
    each f32 [num_nodes], or [C, num_nodes] for [C, n] inputs.

    The last tree level only needs leaf weights, so it skips the widest
    [W, d, B] histogram of the tree and takes these totals instead.
    """
    _note_work(*totals_work(grad.shape[-1], num_nodes, grad.shape[0] if grad.dim() == 2 else 1))
    if grad.device.type == "cpu":
        return _totals_plain(grad, hess, node_local, num_nodes)
    return _totals_cuda(grad, hess, node_local, num_nodes)


# ----------------------------------------------------------- plain versions


def _classes(t):
    """A [n] or [C, n] tensor as [C, n] (a view)."""
    return t[None] if t.dim() == 1 else t


def _active_keys(node_local, num_nodes):
    """(class, row, key) of every active entry of [C, n] node ids, in
    class-major row order: key = class * W + node."""
    active = (node_local >= 0) & (node_local < num_nodes)
    cls, rows = torch.nonzero(active, as_tuple=True)
    return cls, rows, cls * num_nodes + node_local[cls, rows].long()


def _hist_plain(bins, grad, hess, node_local, num_nodes, num_bins):
    """index_add_ over flattened (class, node, feature, bin) ids. Each cell
    takes its entries in row order, so class c's cells equal a call on
    class c alone bit for bit."""
    n, d = bins.shape
    W, B = num_nodes, num_bins
    g, h = _classes(grad), _classes(hess)
    C = g.shape[0]
    cls, rows, key = _active_keys(_classes(node_local), W)
    f_ids = torch.arange(d, device=bins.device)
    seg = ((key[:, None] * d + f_ids[None, :]) * B + widen_rows(bins, rows)).reshape(-1)
    G = torch.zeros(C * W * d * B, dtype=torch.float32, device=bins.device)
    H = torch.zeros_like(G)
    G.index_add_(0, seg, g[cls, rows][:, None].expand(-1, d).reshape(-1))
    H.index_add_(0, seg, h[cls, rows][:, None].expand(-1, d).reshape(-1))
    shape = (W, d, B) if grad.dim() == 1 else (C, W, d, B)
    return G.reshape(shape), H.reshape(shape)


def _totals_plain(grad, hess, node_local, num_nodes):
    g, h = _classes(grad), _classes(hess)
    C = g.shape[0]
    cls, rows, key = _active_keys(_classes(node_local), num_nodes)
    gt = torch.zeros(C * num_nodes, dtype=torch.float32, device=grad.device)
    ht = torch.zeros_like(gt)
    gt.index_add_(0, key, g[cls, rows])
    ht.index_add_(0, key, h[cls, rows])
    shape = (num_nodes,) if grad.dim() == 1 else (C, num_nodes)
    return gt.reshape(shape), ht.reshape(shape)


# ------------------------------------------------------------ CUDA wrappers


def _check_entries(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError("{} is on {}, expected {}".format(name, t.device, device))
    if t.dtype != dtype:
        raise TypeError("{} must be {}, got {}".format(name, dtype, t.dtype))
    if tuple(t.shape) != shape:
        raise ValueError("{} must have shape {}, got {}".format(
            name, list(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("{} must be contiguous".format(name))


def _check_cuda(t):
    if t.device.type != "cuda":
        raise ValueError("expected a CUDA or CPU tensor, got {}".format(t.device))


def _num_sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _hist_cuda(bins, grad, hess, node_local, num_nodes, num_bins):
    from .. import _build

    _check_cuda(bins)
    if bins.dtype not in (torch.uint8, torch.uint16, torch.int32):
        raise TypeError("bins must be uint8, uint16 or int32, got {}".format(bins.dtype))
    if bins.dim() != 2 or not bins.is_contiguous():
        raise ValueError("bins must be a contiguous [n, d] tensor")
    n, d = bins.shape
    if grad.dim() not in (1, 2):
        raise ValueError("grad must be [n] or [C, n], got {}".format(tuple(grad.shape)))
    shape = (grad.shape[0], n) if grad.dim() == 2 else (n,)
    _check_entries("grad", grad, shape, torch.float32, bins.device)
    _check_entries("hess", hess, shape, torch.float32, bins.device)
    _check_entries("node_local", node_local, shape, torch.int32, bins.device)
    if num_nodes < 1 or num_bins < 1:
        raise ValueError("num_nodes and num_bins must be positive")
    C = shape[0] if grad.dim() == 2 else 1
    W, B = num_nodes, num_bins
    # hist_reduce writes every cell
    G = torch.empty((C, W, d, B), dtype=torch.float32, device=bins.device)
    H = torch.empty_like(G)
    if d > 0:
        plan = hist_plan(n, d, W, B, _num_sms(bins.device), classes=C)
        K = C * W
        work = torch.empty(2 * K * plan.count_ctas + K + 1 + C * n, dtype=torch.int32,
                           device=bins.device)
        pieces = torch.empty(2 * plan.slots * d * B, dtype=torch.float32,
                             device=bins.device)
        _build.kernels().hist(bins, grad, hess, node_local, G, H, work, pieces, plan)
        LAUNCHES["hist_kernel"] += 1
    if grad.dim() == 1:
        return G[0], H[0]
    return G, H


def _totals_cuda(grad, hess, node_local, num_nodes):
    from .. import _build

    _check_cuda(grad)
    if grad.dim() not in (1, 2):
        raise ValueError("grad must be [n] or [C, n], got {}".format(tuple(grad.shape)))
    shape = tuple(grad.shape)
    _check_entries("grad", grad, shape, torch.float32, grad.device)
    _check_entries("hess", hess, shape, torch.float32, grad.device)
    _check_entries("node_local", node_local, shape, torch.int32, grad.device)
    g2 = _classes(grad)
    C, n = g2.shape
    plan = totals_plan(n, num_nodes, _num_sms(grad.device), classes=C)
    # totals_reduce writes every cell: g totals [C, W], then h totals
    out = torch.empty((2, C, num_nodes), dtype=torch.float32, device=grad.device)
    pieces = torch.empty(plan.piece_floats, dtype=torch.float32, device=grad.device)
    _build.kernels().totals(g2, _classes(hess), _classes(node_local), out, pieces, plan)
    LAUNCHES["totals_kernel"] += 1
    if grad.dim() == 1:
        return out[0, 0], out[1, 0]
    return out[0], out[1]
