"""Median job time, from the render call to the image on the host (host
clock, every job of the traced part of the window)."""

from lrbench import stats

LAYER = "entry"


def read(run):
    lat = [(r.t1 - r.t0) * 1e3 for r in run.job.traced()]
    return stats.percentile(lat, 50) if lat else None
