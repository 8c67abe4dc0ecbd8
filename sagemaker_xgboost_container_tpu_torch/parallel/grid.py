"""The data x feature grid: the port's counterpart of the JAX package's 2-D
``Mesh(devices.reshape(rows, cols), ("data", "feature"))``.

``build_grid(F)`` lays R ranks (the world, or a given group) out as R / F
data shards of F feature shards each, as the JAX reshape lays its devices
out: rank r sits at data index ``r // F`` and feature index ``r % F``, so a
feature group is F consecutive ranks. The ranks of one data shard hold the
same rows, each only its own column slice of their bins; the ranks of one
feature index hold the same columns of different rows.

* the **data group** (the R / F ranks of one feature index) carries every
  collective over rows: the histograms, the node totals, the merged cuts,
  the metrics and the learning stats;
* the **feature group** (the F ranks of one data shard) carries the split
  merge (``ops/split.combine_splits_across_shards``), the node-totals
  broadcast and the owner's routing decisions.

F = 1 is the 1-D data case, R = F a feature-only grid. Every rank creates
every subgroup, in the same order, as ``torch.distributed.new_group``
requires. A feature group must stay within one host, as the JAX package
refuses a feature axis that spans processes: its routing decisions cross
the feature group once a level.
"""

import socket

from ..toolkit import exceptions as exc

SPANS_HOSTS_MESSAGE = (
    "The 'feature' mesh axis must not span processes: build the mesh with the data axis "
    "across hosts and the feature axis over each host's local devices.")


class Grid:
    """One rank's place in a data x feature grid and the two groups it
    belongs to. ``world`` is the group the grid was built over, ``n_hosts``
    the hosts its ranks run on."""

    def __init__(self, world, data_group, feature_group, data_rank, feature_rank, n_data,
                 n_feature, n_hosts=1):
        self.world = world
        self.n_hosts = n_hosts
        self.data_group = data_group
        self.feature_group = feature_group
        self.data_rank = data_rank
        self.feature_rank = feature_rank
        self.n_data = n_data
        self.n_feature = n_feature

    def __repr__(self):
        return "Grid({} x {}, data rank {}, feature rank {})".format(
            self.n_data, self.n_feature, self.data_rank, self.feature_rank)


def plan_grid(world_size, n_feature, host_keys=None):
    """The layout of ``world_size`` ranks as a grid of ``n_feature``
    feature shards -> (data groups, feature groups), each a list of rank
    lists (indices into the world): data group f holds the ranks of feature
    index f, feature group s the F ranks of data shard s. ``host_keys``:
    each rank's host (any comparable value); a feature group over two
    hosts raises ``UserError``, as does an F that does not divide the
    world."""
    n_feature = int(n_feature)
    if n_feature < 1 or world_size % n_feature:
        raise exc.UserError(
            "the feature axis of {} shards does not divide the {} ranks of the grid".format(
                n_feature, world_size))
    n_data = world_size // n_feature
    feature_groups = [list(range(s * n_feature, (s + 1) * n_feature)) for s in range(n_data)]
    data_groups = [list(range(f, world_size, n_feature)) for f in range(n_feature)]
    if host_keys is not None:
        for members in feature_groups:
            if len({host_keys[r] for r in members}) > 1:
                raise exc.UserError(SPANS_HOSTS_MESSAGE)
    return data_groups, feature_groups


def _host_key():
    """This process's host: its place in the local-rank topology when it
    trains with local ranks, else the machine's host name."""
    from . import local

    topo = local.topology()
    if topo is not None:
        return ("topology", topo.host_index)
    return ("host", socket.gethostname())


def build_grid(n_feature, group=None):
    """This rank's ``Grid`` of ``n_feature`` feature shards over ``group``
    (the default group when None). Every rank of the group calls it with
    the same ``n_feature``; it exchanges the ranks' hosts once and creates
    every data and feature group."""
    import torch.distributed as dist

    base = dist.group.WORLD if group is None else group
    members = dist.get_process_group_ranks(base)
    me = dist.get_rank(base)
    keys = [None] * len(members)
    dist.all_gather_object(keys, _host_key(), group=base)
    data_groups, feature_groups = plan_grid(len(members), n_feature, keys)
    mine = {}
    for kind, layout in (("data", data_groups), ("feature", feature_groups)):
        for ranks in layout:
            pg = dist.new_group([members[r] for r in ranks])
            if me in ranks:
                mine[kind] = pg
    return Grid(base, mine["data"], mine["feature"], me // n_feature, me % n_feature,
                len(members) // n_feature, n_feature, n_hosts=len(set(keys)))
