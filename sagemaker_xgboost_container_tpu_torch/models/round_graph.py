"""K boosting rounds a dispatch, replayed from one captured CUDA graph.

The port's counterpart of the JAX package's ``jax.jit(multi_round,
donate_argnums=...)`` over a ``lax.scan`` of K rounds: on one CUDA rank a
training session captures its round body once (``torch.cuda.CUDAGraph``),
after a real, committed, eager warm-up round, and replays the graph once a
round; each replay's outputs (the packed trees, the per-round device
metrics, the learning stats) are copied into slot k of the dispatch's static
``[K, ...]`` buffers, which reach the host in one copy. The graph records
everything the round enqueues on the device: the gradients, the tree
growth (``build_tree``) with its 8 ``hist_*`` and 1 ``totals_*`` kernel
launches a depth-8 tree, the margin updates of the training rows and of every eval set,
the metrics and the packing.

The graph holds the pointers of the tensors it read at capture, so the
session's state is updated in place (``add_`` / ``mul_``), never rebound,
while a graph is armed. What differs from round to round stays outside the
graph: the poison drill's margin write, and the round's random draws
(``models/sampling``), which are drawn eagerly and copied into static
buffers before each replay, so replay k sees the draws of round k bit for
bit.

Which sessions capture is decided statically, at session start
(``capture_decision``), and logged once with its reason; a configuration
marked captured whose capture or replay fails raises. The others run their K
rounds eagerly, with the same K semantics and the same one copy a dispatch.

The kernel wrappers count their launches in Python (``ops/histogram``
``LAUNCHES`` / ``WORK``), which a replay does not run: the capture records
what the counters advanced by while it recorded, sets them back, and every
replay adds that much.
"""

import ctypes

import torch

from ..ops import histogram

# The functions a capture records, as "module:qualname" under the package:
# the lint gate's capture pass (toolkit/graftlint/passes/capture.py) holds
# them, and every function they reach, to the rules of a captured region.
CAPTURED_ROOTS = ("models.booster:_TrainingSession._round_body",)


def capture_decision(device, rounds_per_dispatch, group, config, approx_resketch):
    """Does a session of this configuration replay its rounds from a CUDA
    graph? -> (captured, reason). Static: it reads the configuration only,
    never a round."""
    if device.type != "cuda":
        return False, "a {} session runs its rounds eagerly".format(device.type)
    if config.booster != "gbtree":
        return False, "booster={} runs its own round loop".format(config.booster)
    if approx_resketch:
        return False, "tree_method=approx re-bins the rows before every round"
    if rounds_per_dispatch <= 1:
        return False, "one round a dispatch (_rounds_per_dispatch=1)"
    if group is not None:
        return False, "the round's collectives across ranks wait on the host"
    return True, "one CUDA rank, gbtree with {} growth".format(config.grow_policy)


def _clone(tree):
    """A fresh copy of a (nested) draw structure: tuples, namedtuples and
    lists of tensors or None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(x) for x in tree))
    return type(tree)(_clone(x) for x in tree)


def _copy_into(static, new):
    """Copy ``new``'s tensors into ``static``'s, which have the same
    structure; a round whose draws change shape cannot replay."""
    if static is None or new is None:
        if static is not None or new is not None:
            raise RuntimeError("a round's draws changed structure under a captured graph")
        return
    if isinstance(static, torch.Tensor):
        if static.shape != new.shape or static.dtype != new.dtype:
            raise RuntimeError("a round's draws changed shape under a captured graph: "
                               "{} {} -> {} {}".format(tuple(static.shape), static.dtype,
                                                      tuple(new.shape), new.dtype))
        static.copy_(new)
        return
    if len(static) != len(new):
        raise RuntimeError("a round's draws changed structure under a captured graph")
    for s, n in zip(static, new):
        _copy_into(s, n)


def graph_node_count(graph):
    """Nodes of a captured graph (its kernels, copies and fills) through
    libcuda's ``cuGraphGetNodes``, or None where the graph or libcuda does
    not say."""
    try:
        handle = graph.raw_cuda_graph()
        handle = handle if isinstance(handle, int) else int(handle.getPtr())
        count = ctypes.c_size_t(0)
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
        if lib.cuGraphGetNodes(ctypes.c_void_p(handle), None, ctypes.byref(count)) != 0:
            return None
        return int(count.value)
    except Exception:  # best-effort report: an older torch keeps no raw graph
        return None


class RoundGraph:
    """One session's captured round: ``capture(draws)`` records
    ``body(static draws)`` once, ``replay(draws)`` runs it again with the
    round's draws copied in and returns the body's outputs, which the next
    replay overwrites; ``release()`` frees the graph and its memory pool."""

    def __init__(self, body):
        self.body = body
        self.graph = None
        self.outputs = None
        self.static_draws = None
        self.launches = {}
        self.work = {}
        self.nodes = None

    @property
    def armed(self):
        return self.graph is not None

    def capture(self, draws):
        """Record one round. The round is not run: the caller replays."""
        self.static_draws = _clone(draws)
        launches, work = dict(histogram.LAUNCHES), dict(histogram.WORK)
        try:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError:  # a torch without keep_graph: no node count
            graph = torch.cuda.CUDAGraph()
        # thread_local: the telemetry threads' own CUDA calls must not
        # invalidate the capture of this one
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = self.body(self.static_draws)
        self.launches = {k: histogram.LAUNCHES[k] - launches[k] for k in launches}
        self.work = {k: histogram.WORK[k] - work[k] for k in work}
        histogram.LAUNCHES.update(launches)
        histogram.WORK.update(work)
        self.graph, self.outputs = graph, outputs
        self.nodes = graph_node_count(graph)
        if hasattr(graph, "instantiate"):
            graph.instantiate()

    def replay(self, draws):
        _copy_into(self.static_draws, draws)
        self.graph.replay()
        for k, v in self.launches.items():
            histogram.LAUNCHES[k] += v
        for k, v in self.work.items():
            histogram.WORK[k] += v
        return self.outputs

    def release(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.outputs = self.static_draws = None
