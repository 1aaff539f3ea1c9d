"""Faults planted under the timed path, to show that `correct` catches
them: each takes a set-up job and breaks what its window produces.

  stale    every job returns the image made before the window (a step that
           returns its state unchanged);
  half     the camera renders half of its samples and the film takes the
           mean over them (half of the batch left out);
  altered  the last sample pass's radiance is scaled by 1.01 where the
           integrator produces it (an answer altered where it is made).

A cell on one chip has no exchange between chips to leave out. Each
returns a function that undoes what it patched outside the job.
"""

from __future__ import annotations


def stale(job):
    before = job.entry()
    job.entry = lambda: before
    return lambda: None


def half(job):
    job.sc.cameras[0].spp = job.spp // 2
    return lambda: None


def altered(job):
    from luisarender_tpu_torch.integrators import mega_path

    inner = mega_path.path_trace_batch
    last = job.spp - 1

    def path_trace_batch(*args, **kw):
        out = inner(*args, **kw)
        if args[5] != last:  # the sample index
            return out
        return (out[0] * 1.01,) + tuple(out[1:])

    mega_path.path_trace_batch = path_trace_batch

    def undo():
        mega_path.path_trace_batch = inner

    return undo


FAULTS = {"stale": stale, "half": half, "altered": altered}
