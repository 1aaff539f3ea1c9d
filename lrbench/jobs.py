"""The general generator: the job kinds a traffic file names, each driving
the program's entry from the seed and keeping what `correct` compares.

`render`: final frames. A closed loop with one client: each job renders
the configuration's scene at the traffic's resolution and samples a pixel
through `scene.integrator.render(compiled)` (the path of
luisarender_tpu_torch.render, compiled once at set-up) with its own sampler
seed, drawn from --seed, and ends with the image on the host.
"""

from __future__ import annotations

import copy
import math
import sys
import time
import traceback
from typing import NamedTuple

import numpy as np

from . import profiling, spec, stats


class JobRecord(NamedTuple):
    t0: float
    t1: float  # math.inf where the job failed
    ok: bool
    samples: int  # pixel samples the job completed
    rays: int  # the program's rays_traced counter after the job
    traced: bool  # the job ran inside the traced part of the window


def scene_dict(config, traffic):
    """The scene the cell renders, handed alike to the program and the
    reference: the configuration file's `scene`, at the traffic's
    resolution and samples a pixel."""
    scene = copy.deepcopy(config["scene"])
    cam = scene["render"]["cameras"][0]["prop"]
    cam["film"]["prop"]["resolution"] = list(traffic["resolution"])
    cam["spp"] = int(traffic["spp"])
    return scene


def draw_seeds(seed, n):
    """n sampler seeds (uint32) for jobs 0..n-1, from the run's seed."""
    return np.random.default_rng([int(seed), 1]).integers(0, 2 ** 32, size=n, dtype=np.uint64)


class RenderJobs:
    """Final-frame rendering, one client, jobs back to back."""

    MAX_JOBS = 100_000

    def __init__(self, cell, seed, device):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.traffic = cell.traffic
        self.scene = scene_dict(cell.config, cell.traffic)
        self.res = tuple(self.traffic["resolution"])
        self.spp = int(self.traffic["spp"])
        self.job_seeds = draw_seeds(seed, self.MAX_JOBS + 1)
        w, h = self.res
        n_px = int(cell.checks["pixels"])
        rng = np.random.default_rng([self.seed, 2])
        self.check_idx = np.sort(rng.choice(w * h, size=min(n_px, w * h), replace=False))
        self.records = []
        self.kept = []  # per job: the sampled pixels of its image
        self.compile_s = None
        self.window = None
        self.entry = None  # the call a job makes; the fault tests replace it

    def setup(self):
        t = time.perf_counter()
        import luisarender_tpu_torch as lt

        sc = lt.Scene.from_dict(copy.deepcopy(self.scene))
        t_import = time.perf_counter() - t
        t = time.perf_counter()
        self.compiled = lt.compile_scene(sc, device=self.device)
        self.compile_s = time.perf_counter() - t
        self.integrator = sc.integrator
        self.file = sc.cameras[0].file
        self.sc = sc
        self.entry = lambda: self.integrator.render(self.compiled)[self.file]
        # the warm-up job: every kernel built, every shape the window uses
        self.integrator.sampler.seed = int(self.job_seeds[self.MAX_JOBS])
        t = time.perf_counter()
        self.entry()
        print(f"lrbench: set-up: program import {t_import:.3f} s, compile {self.compile_s:.3f} s, "
              f"warm-up job {time.perf_counter() - t:.3f} s", file=sys.stderr)

    def run_window(self, seconds, rec):
        """Jobs back to back for `seconds`; `rec` traces the window's first
        profiling.TRACE_SECONDS where it is enabled."""
        w, h = self.res
        per_job = w * h * self.spp
        rec.start()
        t_start = time.perf_counter()
        k = 0
        while time.perf_counter() - t_start < seconds and k < self.MAX_JOBS:
            if rec.active and time.perf_counter() - t_start >= profiling.TRACE_SECONDS:
                rec.stop()
            self.integrator.sampler.seed = int(self.job_seeds[k])
            t0 = time.perf_counter()
            try:
                with rec.range("job"):
                    img = self.entry()
                t1 = time.perf_counter()
                self.kept.append(np.asarray(img).reshape(-1, 3)[self.check_idx].copy())
                self.records.append(JobRecord(t0, t1, True, per_job,
                                              int(self.integrator.rays_traced), rec.active))
            except Exception:  # a failed job counts, and the run goes on
                traceback.print_exc(file=sys.stderr)
                self.kept.append(None)
                self.records.append(JobRecord(t0, math.inf, False, 0, 0, rec.active))
            k += 1
        done = [r.t1 for r in self.records if r.ok]
        self.window = (t_start, max(done) if done else time.perf_counter())
        rec.stop()

    def release(self):
        """Free the program's state before the reference runs."""
        self.compiled = self.integrator = self.sc = self.entry = None

    def end_to_end(self):
        ok = [r for r in self.records if r.ok]
        lat_ms = [(r.t1 - r.t0) * 1e3 for r in self.records]
        out = {"image_ms_p95": stats.percentile(lat_ms, 95)}
        if ok:
            out["samples_per_s"] = stats.rate(sum(r.samples for r in ok), *self.window) / 1e6
        return out

    def traced(self):
        """The completed jobs of the traced part of the window."""
        return [r for r in self.records if r.ok and r.traced]

    def sample_passes(self):
        """Samples of every pixel that the traced jobs ran."""
        return self.spp * len(self.traced())

    def attempted(self):
        return len(self.records), sum(not r.ok for r in self.records)

    def checked_jobs(self):
        """The jobs the comparison reads: checks["jobs"] of the completed
        ones, drawn from the seed."""
        ok = [k for k, r in enumerate(self.records) if r.ok]
        rng = np.random.default_rng([self.seed, 3])
        n = min(int(self.cell.checks["jobs"]), len(ok))
        return sorted(rng.choice(ok, size=n, replace=False).tolist()) if n else []

    def compare(self, precision_of_program=None):
        """The numbers `correct` compares, over the checked jobs' sampled
        pixels: the program's values, or with precision_of_program the
        reference's own at that precision (the control), against the
        reference. Returns {name: value} and the reference's work counts."""
        import torch

        ref = spec.reference(self.cell.config["reference"])
        w, _ = self.res
        pxy = np.stack([self.check_idx % w, self.check_idx // w], axis=-1)
        counts = ref.Counts()
        # a pixel channel is off where it differs from the reference by more
        # than this share of the reference's value (plus a floor for black)
        rel, floor = self.cell.checks["value_rel"], self.cell.checks["value_floor"]
        off = total = 0
        sum_p = sum_r = 0.0
        jobs = self.checked_jobs()
        for k in jobs:
            seed = int(self.job_seeds[k])
            r = ref.render_pixels(self.scene, self.res, seed, self.spp, pxy, self.device,
                                  counts=counts).double().cpu().numpy()
            if precision_of_program:
                p = ref.render_pixels(self.scene, self.res, seed, self.spp, pxy, self.device,
                                      precision=precision_of_program).double().cpu().numpy()
            else:
                p = np.asarray(self.kept[k], np.float64)
            bad = ~np.isfinite(p) | (np.abs(p - r) > rel * np.abs(r) + floor)
            off += int(bad.sum())
            total += bad.size
            sum_p += float(np.nan_to_num(p, nan=0.0, posinf=0.0).sum())
            sum_r += float(r.sum())
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        if not jobs:
            return {"off_share": 1.0, "mean_gap": 1.0, "jobs_checked": 0}, counts
        return {"off_share": off / total,
                "mean_gap": abs(sum_p - sum_r) / max(sum_r, 1e-30),
                "jobs_checked": len(jobs)}, counts


KINDS = {"render": RenderJobs}


def make(cell, seed, device):
    return KINDS[cell.traffic["job"]](cell, seed, device)
