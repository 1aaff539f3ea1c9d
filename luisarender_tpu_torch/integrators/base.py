"""Integrator interface and the progressive render loop.

Counterpart of luisarender_tpu/integrators/base.py: per camera, film
prepare -> samples -> film develop -> image save. Checkpoint /
resume and shutter buckets (motion blur) are not ported yet.
"""

from __future__ import annotations

import logging
import time as _time

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
        if desc.string("checkpoint_file", ""):
            raise NotImplementedError(
                "checkpoint/resume is not supported by luisarender_tpu_torch yet"
            )
        self.samples_per_pass = desc.int("samples_per_pass", 4)
        # totals of the last render(): rays traced (closest + shadow, as
        # path_trace_batch counts them), bounce steps run on the general
        # fork, and passes of the fused fork (one kernel launch each)
        self.rays_traced = 0
        self.bounces_run = 0
        self.fused_passes = 0

    def _render_one_camera(self, compiled, camera):
        raise NotImplementedError

    def render(self, compiled, save: bool = False) -> dict:
        results = {}
        self.rays_traced = 0
        self.bounces_run = 0
        self.fused_passes = 0
        for camera in compiled.scene.cameras:
            t0 = _time.time()
            image = self._render_one_camera(compiled, camera).cpu().numpy()
            log.info(
                "rendered %s (%dx%d, %d spp) in %.2fs",
                camera.file, *camera.film.resolution, camera.spp,
                _time.time() - t0,
            )
            results[camera.file] = image
            if save:
                imageio.save_image(camera.file, image)
        return results
