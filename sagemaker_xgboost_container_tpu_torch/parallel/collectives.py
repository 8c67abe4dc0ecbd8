"""Tensor collectives of data-parallel training over a ``torch.distributed``
process group: the port's counterparts of ``jax.lax.psum``, ``pmin`` /
``pmax``, ``psum_scatter`` and ``process_allgather``.

Every training-path collective goes through here, so that

* a group of None (one rank) is a no-op on every call, and the one-rank
  paths stay the code they were;
* ``STATS`` counts the calls, the local payload bytes (also by ``kind``:
  "hist", "totals", "merge" for the split merges and node-totals
  broadcasts, "route" for a feature group's routing decisions, "stats",
  "metrics", "setup", and "cuts" for approx's candidates, "rows" for the
  global rows of Cox, "linear" for gblinear's sums, "update" for the
  refresh's node statistics) and the host seconds spent in the calls and
  their waits, in all and by kind (``kind_seconds``, ``kind_calls``;
  ``chip_smoke.py`` phases 17, 18 and 25 read them a round);
* a collective that fails (a peer died: gloo raises when its connection
  closes, NCCL when its watchdog times out) takes the watchdog's
  coordinated abort (exit 80) when the abort plane is up, and otherwise
  raises ``PlatformError``: a rank that cannot reach its peers fails the job.

Async calls (``async_op=True``) return a ``Pending`` whose ``wait()`` is
timed and guarded the same way.
"""

import time

import torch

# the collectives this process ran: calls, local payload bytes (and by
# kind), host seconds
STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "kinds": {}, "kind_seconds": {},
         "kind_calls": {}}


def reset_stats():
    STATS.update(calls=0, bytes=0, seconds=0.0, kinds={}, kind_seconds={}, kind_calls={})


def stats_snapshot():
    """A copy of ``STATS`` whose per-kind dicts do not move with it."""
    return {k: dict(v) if isinstance(v, dict) else v for k, v in STATS.items()}


def stats_delta(before, after=None):
    """``after`` (``STATS`` now when None) less the snapshot ``before`` ->
    {"calls", "bytes", "seconds", "kinds": {kind: {"bytes", "seconds",
    "calls"}}}."""
    after = STATS if after is None else after
    kinds = {}
    for kind in after["kinds"]:
        kinds[kind] = {
            "bytes": after["kinds"][kind] - before["kinds"].get(kind, 0),
            "seconds": (after["kind_seconds"].get(kind, 0.0)
                        - before["kind_seconds"].get(kind, 0.0)),
            "calls": after["kind_calls"].get(kind, 0) - before["kind_calls"].get(kind, 0)}
    return {"calls": after["calls"] - before["calls"],
            "bytes": after["bytes"] - before["bytes"],
            "seconds": after["seconds"] - before["seconds"],
            "kinds": {k: v for k, v in kinds.items() if v["calls"] or v["bytes"]}}


def world(group):
    """(rank, size) of this process in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def _failed(e):
    from ..training import watchdog

    watchdog.on_collective_failure(e)


def _note_seconds(seconds, kind):
    STATS["seconds"] += seconds
    STATS["kind_seconds"][kind] = STATS["kind_seconds"].get(kind, 0.0) + seconds


def _note(nbytes, seconds, kind):
    STATS["calls"] += 1
    STATS["bytes"] += int(nbytes)
    STATS["kinds"][kind] = STATS["kinds"].get(kind, 0) + int(nbytes)
    STATS["kind_calls"][kind] = STATS["kind_calls"].get(kind, 0) + 1
    _note_seconds(seconds, kind)


class Pending:
    """An async collective: ``wait()`` blocks until its result is ready
    (for NCCL, until the current stream is ordered after it) and returns
    the result."""

    def __init__(self, work, result, finish=None, kind="other"):
        self._work = work
        self._result = result
        self._finish = finish
        self._kind = kind

    def then(self, fn):
        """A ``Pending`` whose ``wait()`` returns ``fn`` of this one's result."""
        return Pending(None, self, lambda prev: fn(prev.wait()), self._kind)

    def wait(self):
        if self._work is not None:
            t = time.perf_counter()
            try:
                self._work.wait()
            except Exception as e:
                _failed(e)
                raise
            _note_seconds(time.perf_counter() - t, self._kind)
            self._work = None
        if self._finish is not None:
            self._result, self._finish = self._finish(self._result), None
        return self._result


def _run(call, nbytes, result, async_op, kind, finish=None):
    t = time.perf_counter()
    try:
        work = call()
    except Exception as e:
        _failed(e)
        raise
    _note(nbytes, time.perf_counter() - t, kind)
    pending = Pending(work, result, finish, kind)
    return pending if async_op else pending.wait()


def _op(name):
    import torch.distributed as dist

    return {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
            "max": dist.ReduceOp.MAX}[name]


def all_reduce(t, group, op="sum", async_op=False, kind="other"):
    """Reduce ``t`` in place over ``group`` -> ``t`` (or a ``Pending``)."""
    if group is None:
        return Pending(None, t) if async_op else t
    import torch.distributed as dist

    return _run(lambda: dist.all_reduce(t, op=_op(op), group=group, async_op=async_op),
                t.numel() * t.element_size(), t, async_op, kind)


def reduce_scatter(t, group, async_op=False, kind="other"):
    """Sum ``t`` [P * k, ...] over ``group`` and hand rank r the sum of rows
    [r * k, (r + 1) * k) -> [k, ...] (or a ``Pending``)."""
    if group is None:
        return Pending(None, t) if async_op else t
    import torch.distributed as dist

    _rank, size = world(group)
    out = torch.empty((t.shape[0] // size,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    # reduce_scatter_single where the torch has it (reduce_scatter_tensor
    # is deprecated in its favour), else reduce_scatter_tensor
    call = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    return _run(lambda: call(out, t, group=group, async_op=async_op),
                t.numel() * t.element_size(), out, async_op, kind)


def all_gather(t, group, kind="other"):
    """[P, *t.shape]: every rank's ``t`` in rank order (equal shapes). The
    list form of the call, which every backend takes for CPU and CUDA
    tensors alike."""
    if group is None:
        return t[None]
    import torch.distributed as dist

    _rank, size = world(group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    _run(lambda: dist.all_gather(parts, t, group=group), t.numel() * t.element_size(),
         parts, False, kind)
    return torch.stack(parts)


def host_all_gather(array, group, device, kind="setup"):
    """A numpy array from every rank -> [P, *shape] numpy, through ``device``
    (a collective of the group's backend needs tensors of its device; NCCL
    takes no host tensors). Shapes must be equal on every rank."""
    import numpy as np

    t = torch.as_tensor(np.ascontiguousarray(array), device=device)
    return all_gather(t, group, kind=kind).cpu().numpy()
