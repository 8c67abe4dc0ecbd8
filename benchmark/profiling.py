"""The traced window, read from ``torch.profiler``'s events (CPU and CUDA
activity).

The window is the span of the ``bench.window`` annotation that the harness
opens and closes at dispatch boundaries, after a device synchronize. Device
activity is every kernel, memcpy and memset the profiler recorded on the
card; busy time is the union of their intervals inside the window.
"""

import bisect
import re

import torch

WINDOW = "bench.window"
DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
HIST_KERNELS = re.compile(r"\b(hist|totals)_(count|scan|scatter|kernel|reduce|partial)\b")


class Trace:
    """The window's device intervals, kernel time by name, launch calls and
    host events, in seconds."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        marks = [e for e in events if e.name() == WINDOW
                 and e.device_type() != torch.autograd.DeviceType.CUDA]
        if not marks:
            raise RuntimeError("the traced window's annotation is not in the trace")
        w0 = marks[0].start_ns()
        w1 = w0 + marks[0].duration_ns()
        self.window_s = (w1 - w0) / 1e9
        spans, self.kernel_s, self.launch_calls, host = [], {}, 0, []
        for e in events:
            kind = _kind(e)
            t0, dur = e.start_ns(), e.duration_ns()
            if kind in DEVICE_ACTIVITY:
                a, b = max(t0, w0), min(t0 + dur, w1)
                if b > a:
                    spans.append((a, b))
                if kind == "kernel" and w0 <= t0 < w1:
                    name = e.name()
                    self.kernel_s[name] = self.kernel_s.get(name, 0.0) + dur / 1e9
            elif w0 <= t0 < w1 and kind == "host":
                if e.name() in LAUNCH_CALLS:
                    self.launch_calls += 1
                host.append((t0, t0 + dur, e.name()))
        self.busy, self.gaps = _union(spans, w0, w1)
        self.busy_s = self.busy / 1e9
        host.sort()
        self._host = host
        self._host_starts = [h[0] for h in host]

    def hist_seconds(self):
        return sum(s for name, s in self.kernel_s.items() if HIST_KERNELS.search(name))

    def other_seconds(self):
        return sum(s for name, s in self.kernel_s.items() if not HIST_KERNELS.search(name))

    def breakdown(self, top=10):
        """The device operations that took most time, and the longest idle
        gaps named by the host event that overlaps each most."""
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[_short(n), s] for n, s in ops],
                "idle_gaps": [[self._host_during(a, b), (b - a) / 1e9] for a, b in gaps]}

    def _host_during(self, a, b):
        best, name = 0, "host Python (no traced op)"
        hi = bisect.bisect_left(self._host_starts, b)
        for t0, t1, n in self._host[max(0, hi - 5000):hi]:
            overlap = min(t1, b) - max(t0, a)
            if overlap > best:
                best, name = overlap, n
        return _short(name)


def _kind(e):
    """An event's activity: kernel, gpu_memcpy, gpu_memset, annotation or
    host (older torch's events do not say it themselves)."""
    if e.name() == WINDOW:
        return "annotation"
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        name = e.name()
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        try:
            kind = e.activity_type()
        except AttributeError:
            return "kernel"
        return kind if kind in DEVICE_ACTIVITY else "annotation"
    return "host"


def _short(name):
    name = re.sub(r"\s+", " ", name)
    return name if len(name) <= 100 else name[:97] + "..."


def _union(spans, w0, w1):
    """-> (ns covered by the spans, [(start, end)] of the gaps between
    them inside [w0, w1])."""
    spans.sort()
    busy, gaps, cur = 0, [], w0
    end = w0
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
            busy += end - cur
            cur = a
        end = max(end, b)
    busy += end - cur
    if end < w1:
        gaps.append((end, w1))
    return busy, gaps
