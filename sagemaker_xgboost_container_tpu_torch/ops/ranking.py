"""LambdaMART gradients for rank:pairwise / rank:ndcg / rank:map.

Query groups are laid out once on the host as padded [G, M] row-index
blocks (-1 pads). Each round computes every intra-group pairwise RankNet
gradient of a block as torch ops on the device: a sigmoid of the
score-difference matrix, masked by the label order and weighted by
|delta NDCG| or |delta AP| (LambdaMART), then scattered back to row order.

A row's gradient comes from its own group only, so how the groups are cut
into blocks does not change it. ``build_group_layout`` pads every group to
the largest, as the JAX package does; ``bucket_group_layout`` sorts the
groups by size and pads each block only to its own largest group, which
keeps the O(G * M^2) pair tensors near the pairs the groups really have when
group sizes spread (MSLR: a mean of about 120 documents a query, a tail over
a thousand). A matrix without groups is one group of all its rows: [1, n, n].
"""

import numpy as np
import torch

_SIGMA = 1.0
# groups the JAX package materializes at a time
GROUP_CHUNK = 256
# (group, document, document) cells of one bucketed block: a few f32
# tensors of this size are alive at once
PAIR_BUDGET = 1 << 25


def build_group_layout(groups, max_group_size=None):
    """Group-size array -> row_index [G, M] int32 with -1 padding (groups
    longer than ``max_group_size`` are cut). Host-side, once per dataset."""
    sizes = np.asarray(groups, np.int64)
    if max_group_size is None:
        max_group_size = int(sizes.max())
    G = len(sizes)
    row_index = np.full((G, max_group_size), -1, np.int32)
    start = 0
    for g, size in enumerate(sizes):
        take = min(int(size), max_group_size)
        row_index[g, :take] = np.arange(start, start + take, dtype=np.int32)
        start += int(size)
    return row_index


def assign_groups(groups, n_shards):
    """Deal whole query groups to ``n_shards`` shards -> each shard's group
    indices in channel order: the JAX package's
    ``build_sharded_group_layout`` assignment, longest group first onto the
    shard with the fewest rows (ties to the lowest shard), so that the
    shards' row counts balance and no group straddles two shards."""
    sizes = np.asarray(groups, np.int64)
    order = np.argsort(-sizes, kind="stable")
    assign = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards, np.int64)
    for g in order:
        s = int(np.argmin(loads))
        assign[s].append(int(g))
        loads[s] += sizes[g]
    return [sorted(a) for a in assign]


def chunk_group_layout(row_index, group_chunk=GROUP_CHUNK):
    """[G, M] layout -> blocks of ``group_chunk`` groups, the JAX package's
    chunking."""
    return [row_index[i:i + group_chunk] for i in range(0, len(row_index), group_chunk)]


def bucket_group_layout(groups, pair_budget=PAIR_BUDGET):
    """Group-size array -> blocks [G_b, M_b] int32 (-1 padding): the groups
    in order of size (stable), each block as many consecutive groups as keep
    G_b * M_b^2 within ``pair_budget`` (at least one), padded to its own
    largest group."""
    sizes = np.asarray(groups, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    order = np.argsort(sizes, kind="stable")
    blocks, members = [], []

    def close():
        M = int(sizes[members[-1]])
        block = np.full((len(members), M), -1, np.int32)
        for i, g in enumerate(members):
            block[i, :sizes[g]] = np.arange(starts[g], starts[g] + sizes[g], dtype=np.int32)
        blocks.append(block)

    for g in order:
        if members and (len(members) + 1) * int(sizes[g]) ** 2 > pair_budget:
            close()
            members = []
        members.append(g)
    if members:
        close()
    return blocks


def _ranks(S, valid):
    """1-based rank of each document by score, descending, within its group;
    padding last. A stable sort on (-S, +inf for padding), as
    ``jnp.argsort``, so ties keep row order."""
    key = torch.where(valid, -S, torch.full_like(S, float("inf")))
    order = torch.argsort(key, dim=1, stable=True)
    return order, torch.argsort(order, dim=1, stable=True) + 1


def map_exchange_delta(S, Y, valid):
    """Exact |delta AP| for every intra-group pair swap (binary relevance).

    S, Y, valid: [G, M] scores / labels / validity. For a pair with the
    relevant doc at rank p above the irrelevant at rank q:
    |dAP| = (C(p)/p - C(q)/q + Sum_{k in (p,q)} rel_k/k) / R, with the
    symmetric +1/r_u correction when the relevant doc is the lower one;
    C(k) = #relevant in top-k.
    """
    M = S.shape[1]
    rel = torch.where(valid, (Y > 0).float(), 0.0)
    order, ranks = _ranks(S, valid)
    rel_sorted = torch.gather(rel, 1, order)
    C_sorted = torch.cumsum(rel_sorted, dim=1)
    k_pos = torch.arange(1, M + 1, dtype=torch.float32, device=S.device)[None, :]
    S_sorted = torch.cumsum(rel_sorted / k_pos, dim=1)
    inv_order = ranks - 1
    C_i = torch.gather(C_sorted, 1, inv_order)       # C(r_i)
    S_i = torch.gather(S_sorted, 1, inv_order)       # S(r_i)
    r_f = ranks.float()
    R_total = torch.clamp(rel.sum(dim=1), min=1.0)[:, None, None]
    upper_is_i = (ranks[:, :, None] < ranks[:, None, :]).float()

    def pick(a):
        ai, aj = a[:, :, None], a[:, None, :]
        return (upper_is_i * ai + (1 - upper_is_i) * aj,
                upper_is_i * aj + (1 - upper_is_i) * ai)

    r_u, r_l = pick(r_f)
    C_u, C_l = pick(C_i)
    S_u, S_l = pick(S_i)
    rel_u, rel_l = pick(rel)
    core = C_u / r_u + (1.0 - rel_u) / r_u - C_l / r_l + (S_l - rel_l / r_l) - S_u
    differs = torch.abs(rel[:, :, None] - rel[:, None, :])
    return torch.abs(core) * differs / R_total


def lambdarank_grad_hess(margins, labels, weights, blocks, scheme="pairwise"):
    """Per-row (grad, hess) f32 [n] for LambdaMART.

    margins/labels/weights: [n]; ``blocks``: row-index tensors [G_b, M_b]
    on the margins' device, -1 padding, every row in at most one block
    (``chunk_group_layout`` or ``bucket_group_layout``); scheme: "pairwise"
    (delta = 1) | "ndcg" (|delta NDCG|) | "map" (exact |delta AP| exchange
    weights, binary relevance = label > 0). Rows in no group get 0.
    """
    grad = torch.zeros_like(margins)
    hess = torch.zeros_like(margins)
    for row_index in blocks:
        _lambdarank_block(margins, labels, weights, row_index, scheme, grad, hess)
    return grad, hess


def _lambdarank_block(margins, labels, weights, row_index, scheme, grad, hess):
    """Adds one block's gradients into ``grad`` and ``hess`` (its rows hold
    0 there before)."""
    n = margins.shape[0]
    M = row_index.shape[1]
    valid = row_index >= 0
    safe = torch.clamp(row_index, 0, n - 1).long()
    S = torch.where(valid, margins[safe], 0.0)
    Y = torch.where(valid, labels[safe], float("-inf"))  # padding never "preferred"
    W = torch.where(valid, weights[safe], 0.0)

    s_diff = S[:, :, None] - S[:, None, :]             # [G, M, M]
    rho = 1.0 / (1.0 + torch.exp(_SIGMA * s_diff))     # P(swap needed | i>j)
    prefer = (Y[:, :, None] > Y[:, None, :]) & valid[:, :, None] & valid[:, None, :]

    if scheme == "ndcg":
        _, ranks = _ranks(S, valid)
        gains = torch.where(valid, torch.exp2(torch.where(valid, Y, 0.0)) - 1.0, 0.0)
        discount = 1.0 / torch.log2(1.0 + ranks.float())
        ideal_order = torch.sort(gains, dim=1, descending=True).values
        ideal_discount = 1.0 / torch.log2(
            2.0 + torch.arange(M, dtype=torch.float32, device=S.device))
        max_dcg = torch.clamp((ideal_order * ideal_discount[None, :]).sum(dim=1), min=1e-12)
        delta = (
            torch.abs(gains[:, :, None] - gains[:, None, :])
            * torch.abs(discount[:, :, None] - discount[:, None, :])
            / max_dcg[:, None, None]
        )
    elif scheme == "map":
        delta = map_exchange_delta(S, Y, valid)
    else:
        delta = 1.0

    lam = torch.where(prefer, _SIGMA * rho * delta, 0.0)
    hess_pair = torch.where(prefer, _SIGMA * _SIGMA * rho * (1.0 - rho) * delta, 0.0)

    # i preferred over j: i pulled up (negative grad), j pushed down
    g_mat = (-lam.sum(dim=2) + lam.sum(dim=1)) * W     # [G, M]
    h_mat = torch.clamp(hess_pair.sum(dim=2) + hess_pair.sum(dim=1), min=1e-16) * W
    flat = safe.reshape(-1)
    grad.index_add_(0, flat, torch.where(valid, g_mat, 0.0).reshape(-1))
    hess.index_add_(0, flat, torch.where(valid, h_mat, 0.0).reshape(-1))
