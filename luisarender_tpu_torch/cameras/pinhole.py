"""Pinhole camera.

Counterpart of luisarender_tpu/cameras/pinhole.py:
p = (pixel * 2 - resolution) * tan(fov / 2) / resolution.y;
dir = (p.x, -p.y, -1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import frame as fr
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from .base import Camera


@register(SceneNodeTag.CAMERA, "pinhole", "Pinhole")
class PinholeCamera(Camera):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.fov = desc.float("fov", 35.0)  # degrees, vertical

    def ray_cone(self):
        # the image plane spans 2 tan(fov / 2) over the film's rows at unit distance
        tan_half = float(np.tan(np.deg2rad(self.fov) * 0.5))
        return 0.0, 2.0 * tan_half / float(self.film.resolution[1])

    def _generate_ray_in_camera_space(self, pixel, u_lens):
        res = torch.tensor(self.film.resolution, dtype=torch.float32,
                           device=pixel.device)
        tan_half = float(np.tan(np.deg2rad(self.fov) * 0.5))
        # float32 quotient, as the reference rounds it
        scale = np.float32(tan_half) / np.float32(self.film.resolution[1])
        p = (pixel * 2.0 - res) * float(scale)
        d = fr.normalize(
            torch.stack([p[..., 0], -p[..., 1], -torch.ones_like(p[..., 0])], dim=-1)
        )
        o = torch.zeros_like(d)
        w = torch.ones(p.shape[:-1], dtype=torch.float32, device=pixel.device)
        return o, d, w
