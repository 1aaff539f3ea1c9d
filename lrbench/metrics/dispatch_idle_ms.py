"""Device-idle ms a traced job while the host was inside `lr.samples`: the
card waiting on the sample loop's Python, its `lr.trace` and `lr.film`
spans and the loop's own code between them (spans.py). Under the
profiler, which slows the host, so it reads above the untraced job's
idle."""

from lrbench import spans

LAYER = "entry"


def read(run):
    return spans.idle_ms_per_job(run.trace, "dispatch")
