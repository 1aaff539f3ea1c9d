"""The whole window's share of the card's float32 peak: the operations the
window's paths needed (bounds.fused_bound's count) over the traced
window's seconds times the peak."""

from lrbench import bounds, profiling

LAYER = "device"


def read(run):
    if run.trace is None:
        return None
    bound = bounds.window_bound(run)
    if bound is None:
        return None
    return 100.0 * bound["flops"] / (profiling.window_s(run.trace) * bounds.PEAK_FP32_PER_S)
