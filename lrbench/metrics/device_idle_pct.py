"""Share of the traced window in which no operation ran on the card."""

from lrbench import profiling

LAYER = "device"


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - profiling.busy_s(run.trace) / profiling.window_s(run.trace))
