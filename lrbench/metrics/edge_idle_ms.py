"""Device-idle ms a traced job while the host was inside `lr.render` but
outside `lr.samples`: the job's head, `lr.develop` and `lr.to_host`
(spans.py)."""

from lrbench import spans

LAYER = "entry"


def read(run):
    return spans.idle_ms_per_job(run.trace, "edge")
