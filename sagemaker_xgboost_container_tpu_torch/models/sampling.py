"""Row and column sampling: the random draws of a boosting round.

``subsample``, ``colsample_bytree``, ``colsample_bylevel``,
``colsample_bynode`` and ``num_parallel_tree`` as the JAX package applies
them (``models/booster.py``, ``ops/tree_build.py``, ``ops/lossguide.py``):

* one exact-k-of-d column set a round, without replacement, k =
  max(1, round(colsample_bytree * d)), shared by the round's parallel trees;
* for each of the round's ``num_parallel_tree`` trees its own row keep mask
  (a row is kept with probability ``subsample``; the booster zeroes the
  gradients of the others, which stay routed) and its own level and node
  masks (each feature kept with probability ``colsample_bylevel`` /
  ``colsample_bynode``).

The JAX package draws these from threefry keys inside its jitted round; the
port draws them from a ``torch.Generator`` on the training device, seeded by
(seed, round index), so that a resumed run draws what an uninterrupted one
drew. Threefry's bits cannot be reproduced in torch: ``train`` takes any
object with this class's ``draw`` as a private argument, which is how the
tests replay the JAX package's draws.

Across ranks (``rank`` given) the column masks must be the same on every
rank while each rank keeps only its own rows: the row keep masks then come
from a second generator seeded by (seed, round, rank), so that the column
draws do not depend on the rank's row count (the JAX package likewise
draws its column subsets from a replicated key and its row masks per
shard).
"""

import collections

import numpy as np
import torch

from ..ops.split import ColumnMasks

# One tree's draws: ``keep`` f32 [S, n] (or [n] for one stream), 1 = kept,
# None without row sampling; ``masks`` a ColumnMasks, None without column
# sampling.
TreeDraw = collections.namedtuple("TreeDraw", ["keep", "masks"])


def mask_layout(config):
    """(level rows, node slots) of a tree's masks under ``config``'s growth:
    depthwise trees scan levels 0..max_depth-1 over 2**max_depth - 1 slots;
    lossguide ones have a row for each depth up to the cap and a slot for
    each node (slot 0, the root, is never node-sampled)."""
    if config.grow_policy == "lossguide":
        depth_cap = config.max_depth if config.max_depth > 0 else config.max_leaves
        return depth_cap + 1, 2 * config.max_leaves - 1
    return config.max_depth, 2 ** config.max_depth - 1


def round_seed(seed, rnd):
    """A 63-bit generator seed of (seed, round index)."""
    a, b = np.random.SeedSequence([int(seed) % 2**32, int(rnd)]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


class Sampler:
    """Draws each round's ``TreeDraw``s for ``num_row`` x ``num_col`` rows.

    ``streams``: independent draws side by side on the builder's class axis
    (the folds of fold-parallel CV); 1 shares one draw across a multiclass
    round's classes, as the JAX package does. ``rank``: this rank's index
    in data-parallel training (None on one rank)."""

    def __init__(self, config, num_row, num_col, device, streams=1, rank=None):
        self.config = config
        self.rank = rank
        self.num_row, self.num_col = int(num_row), int(num_col)
        self.device = torch.device(device)
        self.streams = int(streams)
        self.levels, self.slots = mask_layout(config)
        self.lossguide = config.grow_policy == "lossguide"

    @staticmethod
    def needed(config):
        """Does ``config`` sample anything?"""
        return min(config.subsample, config.colsample_bytree, config.colsample_bylevel,
                   config.colsample_bynode) < 1.0

    def draw(self, rnd):
        """-> the ``num_parallel_tree`` TreeDraws of round ``rnd``."""
        cfg, S, n, d = self.config, self.streams, self.num_row, self.num_col
        gen = torch.Generator(device=self.device)
        gen.manual_seed(round_seed(cfg.seed, rnd))

        rows = gen
        if self.rank is not None:
            rows = torch.Generator(device=self.device)
            rows.manual_seed(round_seed(cfg.seed, rnd) ^ round_seed(self.rank + 1, rnd))

        def uniform(*shape, generator=gen):
            return torch.rand(shape, generator=generator, device=self.device)

        tree = None
        if cfg.colsample_bytree < 1.0:
            k = max(1, int(round(cfg.colsample_bytree * d)))
            chosen = torch.argsort(uniform(S, d), dim=1)[:, :k]
            tree = torch.zeros((S, d), device=self.device).scatter_(1, chosen, 1.0)
        draws = []
        for _ in range(cfg.num_parallel_tree):
            keep = level = node = None
            if cfg.subsample < 1.0:
                keep = (uniform(S, n, generator=rows) < cfg.subsample).float()
                keep = keep[0] if S == 1 else keep
            if cfg.colsample_bylevel < 1.0:
                level = (uniform(S, self.levels, d) < cfg.colsample_bylevel).float()
            if cfg.colsample_bynode < 1.0:
                node = (uniform(S, self.slots, d) < cfg.colsample_bynode).float()
                if self.lossguide:
                    node[:, 0] = 1.0
            masks = None
            if tree is not None or level is not None or node is not None:
                masks = ColumnMasks(tree, level, node)
            draws.append(TreeDraw(keep, masks))
        return draws
