"""Integrator interface and the progressive render loop.

Counterpart of luisarender_tpu/integrators/base.py: per camera, film
prepare -> passes of samples -> film develop -> image save, with the
film's accumulation saved to `checkpoint_file` (an .npz of `accum`, `done`,
`spp`) every `checkpoint_interval` samples and resumed from it; the
sampler is seeded by the sample index, so a resumed render is the
uninterrupted one. A camera with a shutter span renders a bucket a
shutter time (the scene compiled anew at each) and averages the buckets
by their weights. After each pass the loop logs its progress and hands
the accumulation to a film that previews it (films/display.py
maybe_preview).
"""

from __future__ import annotations

import logging
import time as _time

import numpy as np
import torch

from ..core import trace
from ..scene.node import SceneNodeDesc, SceneNodeTag
from ..scene.scene import SceneNode
from ..utils import imageio

log = logging.getLogger("luisarender_tpu_torch")


class Integrator(SceneNode):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        sampler_desc = desc.node("sampler")
        if sampler_desc is None:
            sampler_desc = SceneNodeDesc(
                identifier="$default_sampler",
                tag=SceneNodeTag.SAMPLER,
                impl_type="independent",
            )
        self.sampler = scene.load_sampler(sampler_desc)
        ls_desc = desc.node("light_sampler")
        if ls_desc is None:
            ls_desc = SceneNodeDesc(
                identifier="$default_light_sampler",
                tag=SceneNodeTag.LIGHT_SAMPLER,
                impl_type="uniform",
            )
        self.light_sampler = scene.load_light_sampler(ls_desc)

    def render(self, compiled, save: bool = False) -> dict:
        """Render every camera; returns {camera_file: np image (H, W, 3)}."""
        raise NotImplementedError


class ProgressiveIntegrator(Integrator):
    """Renders each camera into its film, sample by sample or, for the
    megawave integrator, `samples_per_pass` samples per kernel launch."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.samples_per_pass = desc.int("samples_per_pass", 4)
        # the shutter time of the bucket being rendered
        self.render_time = 0.0
        self.checkpoint_file = desc.string("checkpoint_file", "")
        self.checkpoint_interval = desc.int("checkpoint_interval", 8)
        # totals of the last render(): rays traced (closest + shadow, as
        # path_trace_batch counts them; kept on the device, see
        # rays_traced), bounce steps run on the general fork, and passes of
        # the fused fork (one kernel launch each)
        self._rays = 0
        self.bounces_run = 0
        self.fused_passes = 0

    @property
    def rays_traced(self) -> int:
        """Rays the last render() traced. The integrators add each sample's
        count on the device, so a render never waits on it; reading it
        here converts the sum (a host sync)."""
        return int(self._rays)

    def _progressive_loop(self, film, spp, spd, step_fn, device):
        """Passes of at most spd samples until spp: step_fn(accum, done,
        n) -> accum with n more samples from sample index `done`. Resumes
        from the checkpoint file where it holds this film's resolution
        and spp, and saves it every checkpoint_interval samples and at
        the end."""
        accum, done = film.prepare(device), 0
        ckpt = self.checkpoint_file
        if ckpt:
            try:
                data = np.load(ckpt)
                w, h = film.resolution
                if tuple(data["accum"].shape[:2]) == (h, w) and int(data["spp"]) == spp:
                    accum = torch.as_tensor(data["accum"], device=device)
                    done = int(data["done"])
                    log.info("resumed checkpoint %s at %d/%d spp", ckpt, done, spp)
            except (FileNotFoundError, OSError, KeyError):
                pass
        since_ckpt = 0
        with trace.span("lr.samples"):
            while done < spp:
                n = min(spd, spp - done)
                accum = step_fn(accum, done, n)
                done += n
                since_ckpt += n
                log.info("progress: %d/%d spp", done, spp)
                if hasattr(film, "maybe_preview"):
                    film.maybe_preview(accum)
                if ckpt and (since_ckpt >= self.checkpoint_interval or done >= spp):
                    np.savez(ckpt, accum=accum.cpu().numpy(), done=done, spp=spp)
                    since_ckpt = 0
        return accum

    def _render_one_camera(self, compiled, camera):
        raise NotImplementedError

    def _render_camera_with_shutter(self, compiled, camera):
        """The camera's image; with a shutter span, the weighted mean of
        max(shutter_samples, 2) buckets, each compiled and rendered at its
        shutter time."""
        t0s, t1s = camera.shutter_span
        if t1s <= t0s:
            return self._render_one_camera(compiled, camera)
        from ..scene.compiler import compile_scene

        times, weights = camera.shutter_weights(max(camera.shutter_samples, 2))
        total = None
        for t, w in zip(times, weights):
            compiled_t = compile_scene(compiled.scene, device=compiled.device, time=float(t))
            self.render_time = float(t)
            try:
                img = self._render_one_camera(compiled_t, camera)
            finally:
                self.render_time = 0.0
            total = img * w if total is None else total + img * w
        return total

    def render(self, compiled, save: bool = False) -> dict:
        with trace.span("lr.render"):
            results = {}
            self._rays = 0
            self.bounces_run = 0
            self.fused_passes = 0
            for camera in compiled.scene.cameras:
                t0 = _time.time()
                image = self._render_camera_with_shutter(compiled, camera)
                with trace.span("lr.to_host"):
                    image = image.cpu().numpy()
                log.info(
                    "rendered %s (%dx%d, %d spp) in %.2fs",
                    camera.file, *camera.film.resolution, camera.spp,
                    _time.time() - t0,
                )
                results[camera.file] = image
                if save:
                    imageio.save_image(camera.file, image)
            return results
