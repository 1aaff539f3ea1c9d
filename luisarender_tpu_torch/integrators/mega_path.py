"""Unidirectional path tracer with NEE + MIS ("megapath"), and its
persistent-threads form ("megawave").

Counterpart of luisarender_tpu/integrators/mega_path.py. A sample takes one
of two forks, as in the reference:
  fused    a scene the fused kernel covers (ops/fused_path.py use_fused)
           renders a sample of every pixel in one kernel launch: the kernel
           makes the camera rays itself for a pinhole camera with a box
           filter and no clip plane (camgen_params), and takes them from
           the caller (trace_paths_fused, its ray-input entry) for every
           other camera, filter or clip plane;
  general  every other scene advances all rays together through a host
           loop over bounces (integrators/common.py bounce_step), its
           traces on the brute-force kernels (the cluster kernel above
           512 triangles). A spectrum that is not fixed (spectra/hero.py)
           always takes it: the fused kernel renders sRGB only.
The megawave integrator renders `samples_per_pass` samples of every pixel
in one persistent launch of the fused kernel; outside the fused kernel's
in-kernel cameras, and on scenes with an environment (whose pre-sampled NEE
candidates need the megapath mode's static draw offsets), it renders as
megapath.
"""

from __future__ import annotations

import torch

from ..core import trace
from ..ops import fused_path
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from . import common
from .base import ProgressiveIntegrator


def camera_rays(camera, sampler, pixel_xy, sample_index, time=0.0):
    """Each pixel's sampler state past its camera draws, and its camera ray
    (the camera posed at shutter time `time`) and weight: the filter's 2D
    draw, then the lens's where the camera samples a lens (u_lens 0.5
    elsewhere). Returns (state, ray, weight)."""
    state = sampler.start(pixel_xy, sample_index)
    state, u_filter = sampler.generate_pixel_2d(state)
    if camera.requires_lens_sampling:
        state, u_lens = sampler.generate_2d(state)
    else:
        u_lens = torch.full((pixel_xy.shape[0], 2), 0.5, dtype=torch.float32,
                            device=pixel_xy.device)
    ray, _, cam_weight = camera.generate_rays(pixel_xy, u_filter, u_lens, time)
    return state, ray, cam_weight


def wavelengths(spectrum, sampler, state, pixel_xy):
    """(state, each lane's wavelengths): a fixed spectrum's (sRGB reads only
    the shape and device of the draws it is given), else sampled from a 1D
    draw that follows the camera's, as in the reference."""
    if spectrum.is_fixed:
        return state, spectrum.sample_wavelengths(pixel_xy[:, :1])
    state, u_swl = sampler.generate_1d(state)
    return state, spectrum.sample_wavelengths(u_swl[..., None])


def general_path_trace_batch(compiled, camera, sampler, light_sampler, pixel_xy,
                             sample_index, *, max_depth, rr_depth, rr_threshold, time=0.0):
    """The general fork: one sample of each pixel of pixel_xy (N, 2) int32
    through the host bounce loop, the camera posed at shutter time `time`.
    Returns (rgb (N, 3), filter weight (N,), stats) with stats 'rays'
    (closest + shadow rays traced, a device tensor) and 'bounces' (bounce
    steps run)."""
    spectrum = compiled.spectrum
    n = pixel_xy.shape[0]
    c = compiled.plan.spectral_dim

    state, ray, cam_weight = camera_rays(camera, sampler, pixel_xy, sample_index, time)
    state, swl = wavelengths(spectrum, sampler, state, pixel_xy)

    # the ray cone only where an image texture reads its footprint
    cone = camera.ray_cone() if compiled.plan.needs_footprint else None
    carry = common.init_carry(ray, cam_weight[..., None].expand(n, c), state, swl, cone=cone)
    bounces = 0
    live = common.has_work(carry)
    while live:
        with trace.span("lr.bounce"):
            carry = common.bounce_step(
                compiled, sampler, light_sampler, carry,
                max_depth=max_depth, rr_depth=rr_depth, rr_threshold=rr_threshold,
            )
            live = common.has_work(carry)
        bounces += 1
    rgb = spectrum.srgb(carry["L"], carry["swl"])
    weight = torch.ones((n,), dtype=torch.float32, device=pixel_xy.device)
    return rgb, weight, {"rays": carry["n_rays"], "bounces": bounces}


def path_trace_batch(compiled, camera, sampler, light_sampler, pixel_xy,
                     sample_index, *, max_depth, rr_depth, rr_threshold,
                     time=0.0, with_stats=False):
    """Trace one sample for each pixel of pixel_xy (N, 2) int32, on the
    fused fork where the scene allows it, else the general one; the camera
    is posed at shutter time `time` on both.

    Returns (rgb (N, 3), filter_weight (N,)); with_stats=True appends a dict
    with 'rays' (closest + shadow rays traced, a device tensor), 'bounces'
    (bounce steps of the general fork) and 'fused' (1 on the fused fork)."""
    kw = dict(max_depth=max_depth, rr_depth=rr_depth, rr_threshold=rr_threshold)
    if not compiled.spectrum.is_fixed and compiled.plan.fused_path:
        raise RuntimeError("a spectrum that is not fixed must never take the fused fork, "
                           "whose kernel renders sRGB only")
    if fused_path.use_fused(compiled, sampler, light_sampler):
        cam = fused_path.camgen_params(camera, sampler.seed, time=time)
        if cam is not None:
            rgb, n_rays = fused_path.trace_paths_fused_camgen(
                compiled, cam, pixel_xy, sample_index, light_sampler=light_sampler, **kw)
        else:
            state0, ray, cam_weight = camera_rays(camera, sampler, pixel_xy, sample_index,
                                                  time)
            rgb, n_rays = fused_path.trace_paths_fused(
                compiled, ray, cam_weight, state0, light_sampler=light_sampler, **kw)
        weight = torch.ones((pixel_xy.shape[0],), dtype=torch.float32, device=pixel_xy.device)
        stats = {"rays": n_rays, "bounces": 0, "fused": 1}
    else:
        rgb, weight, stats = general_path_trace_batch(
            compiled, camera, sampler, light_sampler, pixel_xy, sample_index, time=time, **kw)
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

    def _persistent_camera(self, compiled, camera):
        """The in-kernel camera's parameters where this integrator renders
        the camera in persistent passes (megawave, on the fused fork, with a
        camera the kernel makes, without an environment), else None."""
        if not self.persistent or compiled.plan.has_environment:
            return None
        if not fused_path.use_fused(compiled, self.sampler, self.light_sampler):
            return None
        return fused_path.camgen_params(camera, self.sampler.seed, time=self.render_time)

    def _render_one_camera(self, compiled, camera):
        w, h = camera.film.resolution
        dev = compiled.device
        pixel_xy = pixel_grid(w, h, dev)
        film = camera.film
        rays = [torch.zeros((), dtype=torch.int64, device=dev)]
        spd = max(min(self.samples_per_pass, camera.spp), 1)
        cam = self._persistent_camera(compiled, camera)

        def persistent_pass(accum, done, n):
            # one persistent launch a pass of samples_per_pass samples; the
            # pass's mean enters the film with weight n, as in the reference
            with trace.span("lr.trace"):
                rgb_sum, n_rays = fused_path.trace_paths_fused_persistent(
                    compiled, cam, pixel_xy, done, n, **self._kw())
                rays[0] = rays[0] + n_rays
                self.fused_passes += 1
                rgb = rgb_sum.reshape(h, w, 3) / float(n)
                weight = torch.full((h, w), float(n), dtype=torch.float32, device=dev)
            return film.accumulate_image(accum, rgb, weight)

        def sample_pass(accum, done, n):
            for sample_index in range(done, done + n):
                with trace.span("lr.trace"):
                    rgb, weight, stats = path_trace_batch(
                        compiled, camera, self.sampler, self.light_sampler, pixel_xy,
                        sample_index, time=self.render_time, with_stats=True, **self._kw(),
                    )
                    rays[0] = rays[0] + stats["rays"]
                    self.bounces_run += stats["bounces"]
                    self.fused_passes += stats["fused"]
                accum = film.accumulate_image(accum, rgb.reshape(h, w, 3), weight.reshape(h, w))
            return accum

        accum = self._progressive_loop(film, camera.spp, spd,
                                       persistent_pass if cam is not None else sample_pass, dev)
        self._rays = self._rays + rays[0]
        return film.develop(accum)


@register(SceneNodeTag.INTEGRATOR, "megawave", "MegaWave")
class MegawaveIntegrator(MegakernelPathTracing):
    """Persistent threads: each launch of the fused kernel runs a pass of
    samples_per_pass samples per pixel, and a lane whose path ends starts its
    pixel's next sample in the kernel, so no lane idles at a path boundary.
    Scenes outside the fused kernel's in-kernel cameras render as megapath
    (a ray-input scene: one ray-input launch a sample)."""

    persistent = True
