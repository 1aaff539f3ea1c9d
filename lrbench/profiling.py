"""The one profiler helper of the benchmark: traces the measured window with
torch.profiler (CUPTI on the card) and reduces the trace to device
intervals, host ranges, busy time and the breakdown.

Host ranges come from `torch.profiler.record_function` around the
harness's own calls (`lrbench.window`, `job`, `forward`, ...) and from the
operators PyTorch records; device intervals are every kernel, copy and
set that ran on the card. Times are in the profiler's own clock (ns).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import contextmanager
from typing import NamedTuple

from . import stats

WINDOW_RANGE = "lrbench.window"
TRACE_SECONDS = 20.0  # the traced part of a traced run's window
NAME_CHARS = 96  # a kernel's templated name is cut to this many characters


class Interval(NamedTuple):
    name: str
    start: int
    end: int


class Trace(NamedTuple):
    device: list  # Interval of every device operation
    host: list  # Interval of every host range and operator
    window: tuple  # (start, end) of the traced window


def _span(evt):
    try:
        start, dur = evt.start_ns(), evt.duration_ns()
    except AttributeError:
        start, dur = evt.start_us() * 1000, evt.duration_us() * 1000
    return int(start), int(start + dur)


class Recorder:
    """Traces the first TRACE_SECONDS of the window when enabled: start()
    at the window's start, stop() once that much has passed (or at its
    end); rec.trace is then a Trace, or None when tracing is off. The
    trace is bounded so that reading it keeps a run inside its time limit
    whatever the window's length."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.trace = None
        self._prof = self._range = None

    @property
    def active(self):
        return self._prof is not None

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = record_function(WINDOW_RANGE)
        self._range.__enter__()

    def stop(self):
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.trace = reduce(self._prof.profiler.kineto_results.events())
        self._prof = self._range = None

    def range(self, name):
        """A host range around a call of the harness (a no-op untraced)."""
        if not self.active:
            return _null()
        from torch.profiler import record_function

        return record_function(name)


@contextmanager
def _null():
    yield


def reduce(events) -> Trace:
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for evt in events:
        s, e = _span(evt)
        name = evt.name()
        if evt.device_type() == DeviceType.CPU:
            if name == WINDOW_RANGE:
                window = (s, e)
            else:
                host.append(Interval(name, s, e))
        elif e > s and not evt.is_user_annotation():
            # a host range shows on the device's timeline as an annotation
            # spanning its kernels: not device work
            device.append(Interval(name[:NAME_CHARS], s, e))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    host.sort(key=lambda iv: iv.start)
    return Trace(device=device, host=host, window=window)


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    lo, hi = trace.window
    return stats.busy_time([(d.start, d.end) for d in trace.device], lo, hi) / 1e9


def window_s(trace: Trace) -> float:
    lo, hi = trace.window
    return (hi - lo) / 1e9


def device_seconds(trace: Trace, match) -> float:
    """Summed device seconds of the operations whose name `match` accepts."""
    return sum(d.end - d.start for d in trace.device if match(d.name)) / 1e9


def _host_at(host, starts, t):
    """The innermost host interval open at t: the latest started one that
    has not ended (the ranges nest, so that is the deepest)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        if host[j].end > t:
            return host[j].name
    return "none"


def breakdown(trace: Trace, top=10):
    """{"device_ops": the operations that took most device seconds,
    "idle_gaps": idle seconds summed by what the host was doing as each gap
    began}, each a list of at most `top` [name, seconds]."""
    per_op = defaultdict(int)
    for d in trace.device:
        per_op[d.name] += d.end - d.start
    lo, hi = trace.window
    starts = [h.start for h in trace.host]
    per_gap = defaultdict(int)
    for s, e in stats.idle_gaps([(d.start, d.end) for d in trace.device], lo, hi):
        per_gap[_host_at(trace.host, starts, s)] += e - s
    top_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    top_gaps = sorted(per_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v / 1e9] for k, v in top_ops],
            "idle_gaps": [[k, v / 1e9] for k, v in top_gaps]}
