"""Nishita physical-sky texture.

Counterpart of luisarender_tpu/textures/sky.py: the sky is precomputed on
the host into a lat-long radiance image (utils/sky_precompute.py). A
spherical environment samples it through `rasterize`; on a surface or a
light it is an image texture's row over the shared atlas with the
spherical mapping.
"""

from __future__ import annotations

import numpy as np

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..utils.sky_precompute import precompute_sky
from .base import Texture
from .image import ImageTexture, image_row


@register(SceneNodeTag.TEXTURE, "nishitasky", "NishitaSky", "nishita_sky", "sky")
class NishitaSkyTexture(Texture):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        sun_dir = desc.float3("sun_direction", (0.0, 0.6, 0.8))
        self.sun_intensity = desc.float("sun_intensity", 20.0)
        self.altitude = desc.float("altitude", 100.0)
        res = desc.int2("resolution", (128, 256))
        self.image = precompute_sky(
            resolution=(int(res[0]), int(res[1])),
            sun_direction=tuple(sun_dir),
            sun_intensity=self.sun_intensity,
            altitude=self.altitude,
        )
        alpha = np.ones(self.image.shape[:2] + (1,), np.float32)
        self._rgba = np.ascontiguousarray(np.concatenate([self.image, alpha], axis=-1))

    @property
    def channels(self):
        return 3

    def rasterize(self):
        """The radiance grid a spherical environment samples."""
        return self.image

    def compile(self, compiler) -> int:
        return compiler.register_texture_row(ImageTexture, image_row(
            compiler.register_atlas_image(self._rgba), mapping_type=1))
