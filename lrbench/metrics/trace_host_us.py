"""Median host time of the traced window's `lr.trace` spans: one sample of
every pixel's fork choice, camera parameters, checks, kernel launch and
ray count (the program's spans, spans.py)."""

from lrbench import spans

LAYER = "integrator"


def read(run):
    return spans.host_us(run.trace, "lr.trace")
