"""Closest and shadow rays the program traced (its rays_traced counter,
summed over the traced jobs) per pixel sample."""

LAYER = "integrator"


def read(run):
    ok = run.job.traced()
    samples = sum(r.samples for r in ok)
    return sum(r.rays for r in ok) / samples if samples else None
