"""Wavefront path tracer with a pixel-pinned pool of path slots ("wavepath").

Counterpart of luisarender_tpu/integrators/wave_path.py. An image renders
in tiles of `state_count` consecutive flat pixels (one tile where the pool
holds the image), through one of two pools:

  fused    a scene on the fused fork (ops/fused_path.py use_fused) without
           an environment, whose camera the fused kernel makes
           (camgen_params): one persistent launch of the fused kernel a
           tile, each lane taking all spp samples of its pixel and starting
           the next where a path ends; the tile's mean enters the film
           through accumulate_linear with weight spp.
  general  every other scene: a pool of `state_count` slots advanced one
           bounce an iteration by integrators/common.py bounce_step. Slot i
           owns flat pixel tile_start + i and serves that pixel's samples
           in order. A slot is dead when its path is not active (the
           port's bounce traces its NEE shadow ray inside the bounce). When
           n_dead * refill_den >= state_count * refill_num, the dead slots
           splat their finished paths to the film and start their pixel's
           next sample: one host read of the dead count an iteration, and
           one of the all-done flag every iterations_per_launch
           iterations, at most max_launches times.

A path's draws are seeded by (pixel, sample index) and a pixel's samples
splat in sample order, so when a path starts does not change the image:
the general pool's is megapath's general-fork image but where a sample
exceeds the clamp (the pool clamps a sample to `clamp`, the megapath film
to `clamp` times the pixel's samples so far). At spp <= samples_per_pass
the fused pool's image is megawave's: one launch runs the same arithmetic.
"""

from __future__ import annotations

import logging

import torch

from ..ops import fused_path
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from . import common
from .base import ProgressiveIntegrator
from .mega_path import camera_rays, wavelengths

log = logging.getLogger("luisarender_tpu_torch")


def _pick(mask, new, old):
    """`new` on the lanes of mask (N,), `old` elsewhere, through dicts and
    named tuples of per-lane tensors (lane axis first); a 0-dim tensor (a
    running count) keeps `old`."""
    if isinstance(old, dict):
        return {k: _pick(mask, new[k], old[k]) for k in old}
    if isinstance(old, tuple):
        return type(old)(*(_pick(mask, a, b) for a, b in zip(new, old)))
    if old.dim() == 0:
        return old
    return torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - 1)), new, old)


@register(SceneNodeTag.INTEGRATOR, "wavepath", "WavePath", "wavefront", "wavepathv2",
          "WavePathV2")
class WavefrontPathTracing(ProgressiveIntegrator):
    """Defaults: depth 10, rr_depth 0, rr_threshold 0.95, state_count 2^20,
    iterations_per_launch 8, refill at half the pool dead (1 / 2)."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.max_depth = desc.int("depth", 10)
        self.rr_depth = desc.int("rr_depth", 0)
        self.rr_threshold = desc.float("rr_threshold", 0.95)
        self.state_count = desc.int("state_count", 1 << 20)
        self.iterations_per_launch = desc.int("iterations_per_launch", 8)
        self.refill_num = desc.int("refill_num", 1)
        self.refill_den = desc.int("refill_den", 2)
        # totals of the last render()'s general pool: iterations (one
        # bounce step each, also counted in bounces_run), refills and host
        # reads (dead counts and all-done flags)
        self.iterations_run = 0
        self.refills = 0
        self.host_reads = 0

    def _kw(self):
        return dict(max_depth=self.max_depth, rr_depth=self.rr_depth,
                    rr_threshold=self.rr_threshold)

    def render(self, compiled, save: bool = False) -> dict:
        self.iterations_run = self.refills = self.host_reads = 0
        return super().render(compiled, save)

    def _render_one_camera(self, compiled, camera):
        w, h = camera.film.resolution
        n_pixels = w * h
        pool = min(self.state_count, n_pixels)
        accum = camera.film.prepare(compiled.device)
        if (fused_path.use_fused(compiled, self.sampler, self.light_sampler)
                and not compiled.plan.has_environment):
            cam = fused_path.camgen_params(camera, self.sampler.seed, time=self.render_time)
            if cam is not None:
                return self._render_fused_pool(compiled, camera, cam, pool, accum)
        rays = torch.zeros((), dtype=torch.int64, device=compiled.device)
        for tile_start in range(0, n_pixels, pool):
            accum, n_rays = self._render_tile(compiled, camera, accum, tile_start,
                                              min(pool, n_pixels - tile_start), pool)
            rays = rays + n_rays
        self._rays = self._rays + rays
        return camera.film.develop(accum)

    def _render_fused_pool(self, compiled, camera, cam, pool, accum):
        """One persistent launch a tile of `pool` pixels runs all spp
        samples of each."""
        w, h = camera.film.resolution
        n_pixels, spp, film, dev = w * h, camera.spp, camera.film, compiled.device
        rays = torch.zeros((), dtype=torch.int64, device=dev)
        for tile_start in range(0, n_pixels, pool):
            size = min(pool, n_pixels - tile_start)
            flat = torch.arange(tile_start, tile_start + size, dtype=torch.int32, device=dev)
            pixel_xy = torch.stack([flat % w, flat // w], dim=-1)
            rgb_sum, n_rays = fused_path.trace_paths_fused_persistent(
                compiled, cam, pixel_xy, 0, spp, **self._kw())
            rays = rays + n_rays
            self.fused_passes += 1
            accum = film.accumulate_linear(
                accum, tile_start, rgb_sum / float(spp),
                torch.full((size,), float(spp), dtype=torch.float32, device=dev))
        self._rays = self._rays + rays
        return film.develop(accum)

    def _render_tile(self, compiled, camera, accum, tile_start, tile_size, pool):
        """The general pool over flat pixels [tile_start, tile_start +
        tile_size); slots past tile_size stay dead. Returns (accum, rays
        traced as a device count)."""
        w, h = camera.film.resolution
        spp, film, dev = camera.spp, camera.film, compiled.device
        sampler, spectrum = self.sampler, compiled.spectrum
        c = compiled.plan.spectral_dim
        slot = torch.arange(pool, dtype=torch.int64, device=dev)
        slot_valid = slot < tile_size
        flat = torch.clamp(tile_start + slot, max=w * h - 1)
        pixel_xy = torch.stack([flat % w, flat // w], dim=-1).to(torch.int32)
        # the ray cone only where an image texture reads its footprint
        cone = camera.ray_cone() if compiled.plan.needs_footprint else None

        def generate(sample_index, live):
            """Fresh paths of each slot's pixel at its sample index; only
            the `live` slots are active."""
            state, ray, cam_weight = camera_rays(camera, sampler, pixel_xy, sample_index,
                                                 self.render_time)
            state, swl = wavelengths(spectrum, sampler, state, pixel_xy)
            beta = torch.where(live[:, None], cam_weight[:, None].expand(pool, c), 0.0)
            carry = common.init_carry(ray, beta, state, swl, cone=cone)
            carry["active"] = carry["active"] & live
            return carry

        def splat(carry, accum, unsplatted):
            """The finished paths not yet splatted, added to their pixels."""
            done = ~carry["active"] & unsplatted
            rgb = spectrum.srgb(carry["L"], carry["swl"])
            return film.accumulate_linear(accum, tile_start,
                                          torch.where(done[:, None], rgb, 0.0),
                                          done.to(torch.float32))

        # an all-dead pool; the first iteration fills it
        carry = generate(torch.zeros_like(slot), torch.zeros_like(slot_valid))
        next_sample = torch.zeros_like(slot)
        unsplatted = torch.zeros_like(slot_valid)
        max_launches = (spp * (self.max_depth + 2) * 2) // self.iterations_per_launch + 2
        all_done = False
        for _ in range(max_launches):
            for _ in range(self.iterations_per_launch):
                dead = ~carry["active"]
                self.host_reads += 1
                if int(dead.sum()) * self.refill_den >= pool * self.refill_num:
                    accum = splat(carry, accum, unsplatted)
                    start_new = dead & (next_sample < spp) & slot_valid
                    fresh = generate(torch.where(start_new, next_sample, 0), start_new)
                    carry = _pick(dead, fresh, carry)
                    next_sample = torch.where(start_new, next_sample + 1, next_sample)
                    unsplatted = torch.where(dead, start_new, unsplatted)
                    self.refills += 1
                carry = common.bounce_step(compiled, sampler, self.light_sampler, carry,
                                           **self._kw())
                self.iterations_run += 1
                self.bounces_run += 1
            exhausted = ~carry["active"] & ((next_sample >= spp) | ~slot_valid)
            self.host_reads += 1
            all_done = bool(exhausted.all())
            if all_done:
                break
        if not all_done:
            log.warning("wavepath: tile at %d not done after %d launches", tile_start,
                        max_launches)
        return splat(carry, accum, unsplatted), carry["n_rays"]
