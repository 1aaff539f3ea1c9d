"""The port's one tracing entry point: `span(name)`.

While torch.profiler records, a span is a profiler range, so it lands in
the profiler's trace beside the operators and the device's kernels, on the
same clock. Otherwise it is one shared no-op: a flag check and nothing
built. The range is the profiler's C++ one (`_RecordFunctionFast`, as
compiled graphs use), not `record_function`: under a profiler the latter
costs ~14 us a span on an H100's host and the former ~2, and
`record_function` costs microseconds even with no profiler running.
Turning the profiler on is the only switch, and its trace is the only
store. Spans nest on the host thread: every span of a render lies inside
that render's `lr.render`.

Names carry the prefix `lr.`, so readers of a trace tell them from
PyTorch's own operators:

    lr.render   ProgressiveIntegrator.render, the whole call
    lr.samples  the progressive loop over a camera's samples
    lr.trace    one sample of every pixel (or one persistent pass) and its
                ray count
    lr.film     the film's accumulation of a sample
    lr.develop  the film's develop
    lr.to_host  the image's copy to the host
    lr.bounce   a bounce step of the general fork and its live-path read
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast as _range

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager over the host range `name`: a profiler range while
    a profiler records, else the shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _range(name)
