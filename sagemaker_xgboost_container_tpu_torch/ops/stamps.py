"""Stage clocks inside a boosting round: where a round's device time goes.

A round replayed from a CUDA graph (``models/round_graph``) carries no
profiler ranges, so the round body and the two tree builders stamp the
boundaries of its five stages instead:

==============  ===========================================================
``gradient``    the objective's grad / hess (LambdaMART's pair pass included)
``histogram``   ``level_histogram`` / ``node_totals``, sibling subtraction
``split``       the split scan (``merged_scan``) and the tree arrays
``partition``   routing, node-of-row updates, lossguide's row-wide index ops
``margins``     training and eval margins, device metrics, packing, stats
==============  ===========================================================

A stamp charges the time since the previous one to its stage, so the five
cover the round from its first stamp (``begin``) to its last (``end``, which
charges ``margins``). On a CUDA device a stamp is ``stage_stamp_kernel``
(``csrc/stamp_kernel.cu``, one thread reading ``%globaltimer``), a node of
the captured graph; on the CPU the same call writes the host's nanoseconds,
so the CPU tests drive the same plumbing. Each round of a dispatch writes
its own row of ``rows`` (f64 ``[K, len(STAGES) + 2]``: the stages'
nanoseconds, the first and the last stamp), chosen by an index on the card
that ``end`` moves on, so a graph replayed with the same arguments for
every round still fills row j in round j. The rows ride the dispatch's one
copy to the host beside the trees (``read(k)``): the stamps add no copy.

A session builds a ``StageClock`` only while the tracer records
(``telemetry/tracing.recording``); unarmed, the builders get ``stamp=None``
and each site costs one ``is not None`` test.
"""

import torch

from ..telemetry import tracing

STAGES = ("gradient", "histogram", "split", "partition", "margins")
GRADIENT, HISTOGRAM, SPLIT, PARTITION, MARGINS = range(len(STAGES))
#: index of the round's first stamp in ``read()``; the last follows it
FIRST = len(STAGES)
# the offset's host windows: at most this many, stopping at one this narrow
# (ns; a profiler that has just started slows the first ones)
_OFFSET_TRIES, _OFFSET_NARROW_NS = 20, 50_000


class StageClock:
    """One session's stage rows on ``device``, one a round of a dispatch of
    ``capacity`` rounds: ``begin()`` at each round's start, ``clock(stage)``
    at the end of each stage's work, ``end()`` at the round's end (the next
    round writes the next row, modulo ``capacity``), ``read(k)`` for the
    dispatch's ``[k, len(STAGES) + 2]`` rows. Every dispatch of a session
    but its last runs ``capacity`` rounds, so each starts at row 0."""

    def __init__(self, device, capacity):
        self.device = device
        self.capacity = int(capacity)
        self.rows = torch.zeros(self.capacity, len(STAGES) + 2, dtype=torch.float64,
                                device=device)
        # the latest stamp (exact ns) and the row being written: on the card,
        # or on the CPU as host integers
        self.state = torch.zeros(2, dtype=torch.int64, device=device)
        self._host = [0, 0]
        self._cuda = device.type == "cuda"
        self.offset_ns = None

    def _stamp(self, stage, advance=False):
        if self._cuda:
            from .. import _build

            _build.kernels().stamp(self.rows, self.state, stage, advance)
            return
        now = tracing.now_ns()
        last, r = self._host
        row = self.rows[r]
        if stage < 0:
            row.zero_()
            row[FIRST] = now
        else:
            row[stage] += now - last
        row[FIRST + 1] = now
        self._host = [now, (r + 1) % self.capacity if advance else r]

    def begin(self):
        self._stamp(-1)

    def __call__(self, stage):
        self._stamp(stage)

    def end(self):
        """The round's last stamp, charged to ``margins``: the next round
        writes the next row."""
        self._stamp(MARGINS, advance=True)

    def read(self, k):
        """The dispatch's rows, [k, len(STAGES) + 2] f64 on the device."""
        return self.rows[:k]

    def measure_offset(self):
        """Once a session, outside any capture: the tracer's clock less the
        card's, in nanoseconds, from a stamp right after a host-timed
        synchronize, placed at the middle of the host's window around it
        (the narrowest of a few). Zero on the CPU, whose stamps read the
        tracer's clock."""
        if self.offset_ns is not None:
            return self.offset_ns
        if not self._cuda:
            self.offset_ns = 0
            return 0
        from .. import _build

        rows, state = torch.zeros_like(self.rows[:1]), torch.zeros_like(self.state)
        best = None
        for _ in range(_OFFSET_TRIES):
            torch.cuda.synchronize(self.device)
            h0 = tracing.now_ns()
            _build.kernels().stamp(rows, state, -1)
            torch.cuda.synchronize(self.device)
            h1 = tracing.now_ns()
            d = int(state[0].item())
            if best is None or h1 - h0 < best[0]:
                best = (h1 - h0, (h0 + h1) // 2 - d)
            if best[0] < _OFFSET_NARROW_NS:
                break
        self.offset_ns = best[1]
        return self.offset_ns
