"""Thin-lens and orthographic cameras.

Counterpart of luisarender_tpu/cameras/impls.py:
- thin lens: focal length in mm, f-number aperture (lens radius 0.5 f / N),
  a 36 x 24 mm sensor whose projected size follows the film's orientation,
  the focus distance from `focus_position` or `focus_distance`, and a
  concentric-disk lens sample;
- ortho: parallel projection scaled by 2^-zoom.
Each gives the reference's one-pixel ray cone (`ray_cone`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import frame as fr
from ..core.sampling import sample_uniform_disk_concentric
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from .base import Camera


@register(SceneNodeTag.CAMERA, "thinlens", "ThinLens", "thin_lens")
class ThinLensCamera(Camera):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.aperture = desc.float("aperture", 2.0)  # f-number
        self.focal_length = desc.float("focal_length", 35.0)  # mm
        focus = desc.float3("focus_position", None)
        if focus is not None:
            origin = np.asarray(self.camera_to_world()[:3, 3])
            self.focus_distance = float(np.linalg.norm(np.asarray(focus) - origin))
        else:
            self.focus_distance = desc.float("focus_distance", 1.0)

    @property
    def requires_lens_sampling(self):
        return True

    def ray_cone(self):
        # the sensor pixel's angle; the aperture's blur is left out, as in
        # the reference (a narrower cone only picks a sharper level)
        w, h = self.film.resolution
        sensor_h = 0.024 if w >= h else 0.036
        return 0.0, (sensor_h / h) / (self.focal_length * 1e-3)

    def _generate_ray_in_camera_space(self, pixel, u_lens):
        w, h = self.film.resolution
        # the 36 x 24 mm sensor's projected size, by orientation
        if w >= h:
            sensor_w, sensor_h = 0.036, 0.036 * h / w
            if sensor_h > 0.024:
                sensor_h, sensor_w = 0.024, 0.024 * w / h
        else:
            sensor_h, sensor_w = 0.036, 0.036 * w / h
            if sensor_w > 0.024:
                sensor_w, sensor_h = 0.024, 0.024 * h / w
        f = self.focal_length * 1e-3
        lens_radius = 0.5 * f / self.aperture
        # the image plane's distance by the lens equation: 1/f - 1/zf in
        # double, its reciprocal in float32, as the reference rounds them
        zf = self.focus_distance
        zi = float(np.float32(1.0) / np.float32(max(1.0 / f - 1.0 / zf, 1e-8)))

        res = torch.tensor(self.film.resolution, dtype=torch.float32, device=pixel.device)
        ndc = pixel / res
        # the point on the (virtual) sensor, flipped through the lens centre,
        # and the point it focuses to
        psx = (0.5 - ndc[..., 0]) * sensor_w
        psy = (ndc[..., 1] - 0.5) * sensor_h
        p_focus = torch.stack(
            [-psx * zf / zi, psy * zf / zi, torch.zeros_like(psx) - float(np.float32(zf))],
            dim=-1,
        )
        d = sample_uniform_disk_concentric(u_lens) * lens_radius
        o = torch.cat([d, torch.zeros_like(d[..., :1])], dim=-1)
        direction = fr.normalize(p_focus - o)
        return o, direction, torch.ones_like(psx)


@register(SceneNodeTag.CAMERA, "ortho", "Ortho", "orthographic", "Orthographic")
class OrthographicCamera(Camera):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.zoom = desc.float("zoom", 0.0)

    def ray_cone(self):
        # parallel rays: a constant one-pixel width
        return 2.0 * float(2.0 ** -self.zoom) / float(self.film.resolution[1]), 0.0

    def _generate_ray_in_camera_space(self, pixel, u_lens):
        res = torch.tensor(self.film.resolution, dtype=torch.float32, device=pixel.device)
        scale = float(2.0 ** -self.zoom)
        p = (pixel * 2.0 - res) / res[1] * scale
        o = torch.stack([p[..., 0], -p[..., 1], torch.zeros_like(p[..., 0])], dim=-1)
        d = torch.zeros_like(o)
        d[..., 2] = -1.0
        return o, d, torch.ones_like(p[..., 0])
