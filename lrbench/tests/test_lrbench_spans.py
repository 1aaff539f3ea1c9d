"""spans.py and the four readers of the program's spans, on a hand-built
trace of two jobs with known spans and device gaps: each reader's value,
a gap that runs from one job's `lr.to_host` through the harness into the
next job's head split across them, the three classes adding up to the
window's idle time exactly, and nothing read from a program without the
spans."""

from types import SimpleNamespace

import pytest

from lrbench import profiling, spans, spec, stats

US = 1000  # the profiler's clock is in ns; the times below are in us

# two jobs: (name, start, end) in us
HOST = [
    ("job", 8, 402),
    ("lr.render", 10, 400), ("lr.samples", 15, 195),
    ("lr.trace", 20, 60), ("aten::add", 30, 35), ("lr.film", 70, 100),
    ("lr.trace", 110, 150), ("lr.film", 160, 190),
    ("lr.develop", 200, 220), ("lr.to_host", 230, 300),
    ("job", 418, 802),
    ("lr.render", 420, 800), ("lr.samples", 425, 590),
    ("lr.trace", 430, 460), ("lr.bounce", 435, 455), ("lr.film", 470, 480),
    ("lr.trace", 490, 540), ("lr.film", 550, 570),
    ("lr.develop", 600, 620), ("lr.to_host", 630, 700),
]
# device work; the gaps between are the idle time
DEVICE = [(5, 25), (40, 75), (80, 102), (108, 200), (210, 290), (440, 450), (452, 610),
          (612, 950)]
WINDOW = (0, 1000)

# each gap's pieces: (start, end, class)
PIECES = [
    (0, 5, "harness"),
    (25, 40, "dispatch"),  # in lr.trace
    (75, 80, "dispatch"),  # in lr.film
    (102, 108, "dispatch"),  # in lr.samples, between two samples
    (200, 210, "edge"),  # in lr.develop
    # one gap: lr.to_host, the render's end, the harness, the next job's
    # head, its sample loop, its first lr.trace and the lr.bounce inside it
    (290, 300, "edge"), (300, 400, "edge"), (400, 420, "harness"),
    (420, 425, "edge"), (425, 430, "dispatch"), (430, 435, "dispatch"),
    (435, 440, "dispatch"),
    (450, 452, "dispatch"),  # in lr.bounce, inside lr.trace
    (610, 612, "edge"),  # in lr.develop
    (950, 1000, "harness"),
]


def _trace(host=HOST):
    return profiling.Trace(
        device=[profiling.Interval("k", s * US, e * US) for s, e in DEVICE],
        host=sorted((profiling.Interval(n, s * US, e * US) for n, s, e in host),
                    key=lambda iv: iv.start),
        window=(WINDOW[0] * US, WINDOW[1] * US))


def _expected(cls):
    return sum(e - s for s, e, c in PIECES if c == cls) * US


def test_the_pieces_cover_the_idle_gaps():
    gaps = stats.idle_gaps(DEVICE, *WINDOW)
    assert sum(e - s for s, e in gaps) == sum(e - s for s, e, _ in PIECES)


def test_idle_split_by_class():
    assert spans.idle_split(_trace()) == {c: _expected(c) for c in spans.CLASSES}


def test_a_gap_from_to_host_to_the_next_head_is_split_across_them():
    pieces = list(spans.idle_pieces(_trace()))
    lo = pieces.index((10 * US, ("lr.render", "lr.to_host")))
    assert pieces[lo:lo + 7] == [
        (10 * US, ("lr.render", "lr.to_host")), (100 * US, ("lr.render",)), (20 * US, ()),
        (5 * US, ("lr.render",)), (5 * US, ("lr.render", "lr.samples")),
        (5 * US, ("lr.render", "lr.samples", "lr.trace")),
        (5 * US, ("lr.render", "lr.samples", "lr.trace", "lr.bounce"))]


def test_the_classes_add_up_to_the_window_idle_exactly():
    trace = _trace()
    lo, hi = trace.window
    idle = sum(e - s for s, e in stats.idle_gaps([(d.start, d.end) for d in trace.device], lo, hi))
    assert sum(spans.idle_split(trace).values()) == idle


@pytest.mark.parametrize("name,value", [
    ("trace_host_us", 40.0),  # durations 40, 40, 30, 50: the nearest-rank median
    ("film_host_us", 20.0),  # 30, 30, 10, 20
    ("dispatch_idle_ms", (15 + 5 + 6 + 5 + 5 + 5 + 2) / 1e3 / 2),
    ("edge_idle_ms", (10 + 10 + 100 + 5 + 2) / 1e3 / 2),
])
def test_each_reader(name, value):
    reader = spec.metric_reader(name)
    assert reader.read(SimpleNamespace(trace=_trace())) == pytest.approx(value, rel=1e-12)
    assert reader.read(SimpleNamespace(trace=None)) is None
    # a program without the spans: the harness's and PyTorch's ranges only
    bare = _trace([h for h in HOST if not h[0].startswith("lr.")])
    assert reader.read(SimpleNamespace(trace=bare)) is None
