"""The fused kernel's share of its roofline: the least time of the work the
window's paths needed (bounds.fused_bound, the work counted by the
reference on the checked paths and scaled to the window's samples) over
the kernel's device seconds in the trace."""

from lrbench import bounds, profiling

LAYER = "fused fork"


def read(run):
    if run.trace is None:
        return None
    kernel_s = profiling.device_seconds(run.trace, lambda n: "fused_path_kernel" in n)
    bound = bounds.window_bound(run)
    if kernel_s <= 0.0 or bound is None:
        return None
    return 100.0 * bound["bound_s"] / kernel_s
