"""The program's spans in a traced window, and the device's idle time put
down to them.

The port records host ranges named `lr.*` (luisarender_tpu_torch/core/
trace.py) while a profiler runs; profiling.reduce keeps them among
`trace.host`, on the device's clock. Each idle gap of the device
(stats.idle_gaps over the window) is cut at the edges of those spans, and
each piece goes to what the host was inside then:

    dispatch  `lr.samples`: the progressive loop over the samples, its
              `lr.trace` and `lr.film` spans and its own Python between them
    edge      an `lr.render`, outside `lr.samples`: the job's head,
              `lr.develop`, `lr.to_host`
    harness   no `lr.render`: the benchmark between jobs

A gap that outlasts the span it began in is split across the spans it runs
through, so the three add up to the window's idle time exactly. A trace of
a program without the spans yields nothing (None).
"""

from __future__ import annotations

from . import stats
from .profiling import Interval

PREFIX = "lr."
RENDER = "lr.render"
SAMPLES = "lr.samples"
CLASSES = ("dispatch", "edge", "harness")


def spans(trace, name=None):
    """The window's lr.* host intervals (of `name` alone where given),
    by start."""
    lo, hi = trace.window
    return [h for h in trace.host
            if h.name.startswith(PREFIX) and (name is None or h.name == name)
            and h.start >= lo and h.end <= hi]


def timeline(lr_spans):
    """Disjoint (start, end, names) pieces of the time some span is open,
    in order; `names` are the spans open then, outermost first. The spans
    nest on the one host thread; a child that ends past its parent (clock
    rounding) is cut at the parent's end."""
    out, stack, t = [], [], None

    def to(end):
        nonlocal t
        if stack and end > t:
            out.append((t, end, tuple(s.name for s in stack)))
        t = end if t is None else max(t, end)

    for sp in sorted(lr_spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1].end <= sp.start:
            to(stack[-1].end)
            stack.pop()
        to(sp.start)
        stack.append(Interval(sp.name, sp.start, min(sp.end, stack[-1].end) if stack else sp.end))
    while stack:
        to(stack[-1].end)
        stack.pop()
    return out


def idle_pieces(trace):
    """(ns, names) for every piece of the window's device idle time: the
    spans open then, outermost first (() outside every one)."""
    lo, hi = trace.window
    pieces = timeline(spans(trace))
    i, n = 0, len(pieces)
    for g0, g1 in stats.idle_gaps([(d.start, d.end) for d in trace.device], lo, hi):
        while i < n and pieces[i][1] <= g0:
            i += 1
        t, j = g0, i
        while t < g1:
            if j < n and pieces[j][0] < g1:
                p0, p1, names = pieces[j]
                if p0 > t:
                    yield p0 - t, ()
                    t = p0
                end = min(p1, g1)
                yield end - t, names
                t = end
                j += 1
            else:
                yield g1 - t, ()
                t = g1
        i = max(i, j - 1)


def kind(names):
    """The class of the idle time during which `names` were open."""
    if SAMPLES in names:
        return "dispatch"
    return "edge" if RENDER in names else "harness"


def idle_split(trace):
    """{class: ns} of the window's device idle time."""
    by_class = dict.fromkeys(CLASSES, 0)
    for ns, names in idle_pieces(trace):
        by_class[kind(names)] += ns
    return by_class


def jobs(trace):
    """Renders (lr.render spans) inside the traced window."""
    return len(spans(trace, RENDER))


def idle_ms_per_job(trace, cls):
    """Device-idle ms of class `cls` over the traced window, a traced job;
    None where the trace holds no render span."""
    n = jobs(trace) if trace is not None else 0
    return idle_split(trace)[cls] / 1e6 / n if n else None


def host_us(trace, name):
    """Median host duration, in us, of the window's `name` spans; None
    where there are none."""
    if trace is None:
        return None
    durations = [(s.end - s.start) / 1e3 for s in spans(trace, name)]
    return stats.percentile(durations, 50) if durations else None
