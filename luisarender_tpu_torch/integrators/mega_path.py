"""Unidirectional path tracer with NEE + MIS ("megapath"), and its
persistent-threads form ("megawave").

Counterpart of luisarender_tpu/integrators/mega_path.py. A sample takes one
of two forks, as in the reference:
  fused    a scene the fused kernel covers (ops/fused_path.py use_fused)
           renders a sample of every pixel in one kernel launch;
  general  every other scene advances all rays together through a host
           loop over bounces (integrators/common.py bounce_step), its
           traces on the brute-force kernels.
The megawave integrator renders `samples_per_pass` samples of every pixel
in one persistent launch of the fused kernel; outside the fused kernel's
scenes, and on scenes with an environment (whose pre-sampled NEE candidates
need the megapath mode's static draw offsets), it renders as megapath.
"""

from __future__ import annotations

import torch

from ..ops import fused_path
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from . import common
from .base import ProgressiveIntegrator


def general_path_trace_batch(compiled, camera, sampler, light_sampler, pixel_xy,
                             sample_index, *, max_depth, rr_depth, rr_threshold):
    """The general fork: one sample of each pixel of pixel_xy (N, 2) int32
    through the host bounce loop. Returns (rgb (N, 3), filter weight (N,),
    stats) with stats 'rays' (closest + shadow rays traced, a device
    tensor) and 'bounces' (bounce steps run)."""
    spectrum = compiled.spectrum
    n = pixel_xy.shape[0]
    c = compiled.plan.spectral_dim

    state = sampler.start(pixel_xy, sample_index)
    state, u_filter = sampler.generate_pixel_2d(state)
    u_lens = torch.full((n, 2), 0.5, dtype=torch.float32, device=pixel_xy.device)
    ray, _, cam_weight = camera.generate_rays(pixel_xy, u_filter, u_lens)
    swl = spectrum.sample_wavelengths(n, pixel_xy.device)

    carry = common.init_carry(ray, cam_weight[..., None].expand(n, c), state, swl)
    bounces = 0
    while common.has_work(carry):
        carry = common.bounce_step(
            compiled, sampler, light_sampler, carry,
            max_depth=max_depth, rr_depth=rr_depth, rr_threshold=rr_threshold,
        )
        bounces += 1
    rgb = spectrum.srgb(carry["L"], carry["swl"])
    weight = torch.ones((n,), dtype=torch.float32, device=pixel_xy.device)
    return rgb, weight, {"rays": carry["n_rays"], "bounces": bounces}


def fused_camera(compiled, camera, sampler, light_sampler):
    """The in-kernel camera parameters when the scene takes the fused
    fork, else None."""
    if not fused_path.use_fused(compiled, sampler, light_sampler):
        return None
    cam = fused_path.camgen_params(camera, sampler.seed)
    if cam is None:
        raise NotImplementedError(
            "this camera needs the fused kernel's ray-input entry "
            "(luisarender_tpu ops/fused_path.py trace_paths_fused), which "
            "luisarender_tpu_torch does not have yet"
        )
    return cam


def path_trace_batch(compiled, camera, sampler, light_sampler, pixel_xy,
                     sample_index, *, max_depth, rr_depth, rr_threshold,
                     with_stats=False):
    """Trace one sample for each pixel of pixel_xy (N, 2) int32, on the
    fused fork where the scene allows it, else the general one.

    Returns (rgb (N, 3), filter_weight (N,)); with_stats=True appends a dict
    with 'rays' (closest + shadow rays traced, a device tensor), 'bounces'
    (bounce steps of the general fork) and 'fused' (1 on the fused fork)."""
    kw = dict(max_depth=max_depth, rr_depth=rr_depth, rr_threshold=rr_threshold)
    cam = fused_camera(compiled, camera, sampler, light_sampler)
    if cam is not None:
        rgb, n_rays = fused_path.trace_paths_fused_camgen(
            compiled, cam, pixel_xy, sample_index, light_sampler=light_sampler, **kw)
        weight = torch.ones((pixel_xy.shape[0],), dtype=torch.float32, device=pixel_xy.device)
        stats = {"rays": n_rays, "bounces": 0, "fused": 1}
    else:
        rgb, weight, stats = general_path_trace_batch(
            compiled, camera, sampler, light_sampler, pixel_xy, sample_index, **kw)
        stats["fused"] = 0
    if with_stats:
        return rgb, weight, stats
    return rgb, weight


def pixel_grid(w, h, device):
    """(h * w, 2) int32 pixel coordinates, row-major."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.int32, device=device),
        torch.arange(w, dtype=torch.int32, device=device),
        indexing="ij",
    )
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


@register(SceneNodeTag.INTEGRATOR, "megapath", "MegaPath", "path", "Path")
class MegakernelPathTracing(ProgressiveIntegrator):
    """Defaults: depth 10, rr_depth 0, rr_threshold 0.95."""

    persistent = False  # MegawaveIntegrator sets it

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.max_depth = desc.int("depth", 10)
        self.rr_depth = desc.int("rr_depth", 0)
        self.rr_threshold = desc.float("rr_threshold", 0.95)

    def _kw(self):
        return dict(max_depth=self.max_depth, rr_depth=self.rr_depth,
                    rr_threshold=self.rr_threshold)

    def _render_one_camera(self, compiled, camera):
        w, h = camera.film.resolution
        dev = compiled.device
        pixel_xy = pixel_grid(w, h, dev)
        film = camera.film
        rays = torch.zeros((), dtype=torch.int64, device=dev)
        accum = film.prepare(dev)
        cam = fused_camera(compiled, camera, self.sampler, self.light_sampler)
        if self.persistent and cam is not None and not compiled.plan.has_environment:
            # one persistent launch per pass of samples_per_pass samples; the
            # pass's mean enters the film with weight n, as in the reference
            spd = max(min(self.samples_per_pass, camera.spp), 1)
            done = 0
            while done < camera.spp:
                n = min(spd, camera.spp - done)
                rgb_sum, n_rays = fused_path.trace_paths_fused_persistent(
                    compiled, cam, pixel_xy, done, n, **self._kw())
                rays = rays + n_rays
                self.fused_passes += 1
                accum = film.accumulate_image(
                    accum, rgb_sum.reshape(h, w, 3) / float(n),
                    torch.full((h, w), float(n), dtype=torch.float32, device=dev),
                )
                done += n
            self.rays_traced += int(rays)
            return film.develop(accum)
        for sample_index in range(camera.spp):
            rgb, weight, stats = path_trace_batch(
                compiled, camera, self.sampler, self.light_sampler, pixel_xy,
                sample_index, with_stats=True, **self._kw(),
            )
            rays = rays + stats["rays"]
            self.bounces_run += stats["bounces"]
            self.fused_passes += stats["fused"]
            accum = film.accumulate_image(
                accum, rgb.reshape(h, w, 3), weight.reshape(h, w)
            )
        self.rays_traced += int(rays)
        return film.develop(accum)


@register(SceneNodeTag.INTEGRATOR, "megawave", "MegaWave")
class MegawaveIntegrator(MegakernelPathTracing):
    """Persistent threads: each launch of the fused kernel runs a pass of
    samples_per_pass samples per pixel, and a lane whose path ends starts its
    pixel's next sample in the kernel, so no lane idles at a path boundary.
    Scenes outside the fused kernel render as megapath."""

    persistent = True
