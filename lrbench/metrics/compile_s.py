"""Seconds of compile_scene at set-up (host clock)."""

LAYER = "compile"


def read(run):
    return run.job.compile_s
