"""Median host time of the traced window's `lr.film` spans: the film's
accumulation of one sample (the program's spans, spans.py)."""

from lrbench import spans

LAYER = "film"


def read(run):
    return spans.host_us(run.trace, "lr.film")
