"""The yardstick's peaks and the fused kernel's least time, frozen here so
that a change to the program cannot move them.

The operation counts were counted by hand from csrc/fused_path.cu (+, -, *,
/, sqrt and each transcendental one operation; where a draw picks one of
several lobes, the cheapest) and the peaks are NVIDIA's H100 SXM data sheet
figures at its 700 W limit; both are copied from the port's on-chip smoke
script as it stood when this benchmark was defined. The work itself (rays,
shaded lanes, shadow rays) is counted by the benchmark's own reference on
the same paths, never by the kernel.
"""

from __future__ import annotations

# H100 SXM: HBM bandwidth, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# arithmetic operations of one Moller-Trumbore row test
FLOPS_PER_ROW = 46
# one bounce's shading that every surface type runs (interaction, emission,
# frame, NEE light sample and shadow-ray spawn, the continuation ray,
# throughput and roulette), and per type its two BSDF evaluations and one
# sample
FLOPS_SHADE_COMMON = 330
FLOPS_BSDF = {"matte": 70, "mirror": 367, "metal": 511, "plastic": 480, "glass": 703,
              "disney": 544}
# the megapath mode's bytes a lane and launch: pixel ids in, rgb and a ray
# count out
BYTES_PER_LANE = 24


def fused_bound(rows, shadow_rows, closest, shadow_open, shadow_occluded, shaded_by_type,
                lanes):
    """The least seconds of the fused kernel's work: the larger of its
    operations over the float32 peak and its bytes over the memory rate.
    rows: the scene's triangle rows (every closest ray tests all of them);
    shadow_rows: the rows that block shadow rays (an open shadow ray tests
    all of them, an occluded one is charged one row: the kernel stops at
    its first occluder); shaded_by_type: {surface type: shaded lanes};
    lanes: lane launches (pixels x samples). Returns {bound_s, bound_by,
    flops, bytes}."""
    trace = (closest * rows * FLOPS_PER_ROW + shadow_open * shadow_rows * FLOPS_PER_ROW
             + shadow_occluded * FLOPS_PER_ROW)
    flops = trace + sum(k * (FLOPS_SHADE_COMMON + FLOPS_BSDF[name])
                        for name, k in shaded_by_type.items())
    n_bytes = lanes * BYTES_PER_LANE
    t_ops = flops / PEAK_FP32_PER_S
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return {"bound_s": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "flops": flops, "bytes": n_bytes}


def window_bound(run):
    """fused_bound over the samples of the traced jobs, the reference's
    counts of the checked paths scaled to them; None without counts."""
    w = run.work
    if w is None or not w.lanes:
        return None
    lanes = sum(r.samples for r in run.job.traced())
    scale = lanes / w.lanes
    return fused_bound(w.rows, w.shadow_rows, w.closest * scale, w.shadow_open * scale,
                       w.shadow_occluded * scale,
                       {k: v * scale for k, v in w.shaded_by_type.items()}, lanes)
