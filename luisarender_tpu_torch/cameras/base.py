"""Camera interface with filter-sampled ray generation.

Counterpart of luisarender_tpu/cameras/base.py: per-camera film, filter,
transform, spp, output path and near / far clip planes; `generate_rays` =
filter-sampled pixel offset -> subclass camera-space ray -> camera-to-world
transform, the clip planes' depths turned into the ray's t range; a
shutter span with its buckets' times and weights (motion blur: the
integrator renders a bucket a time, integrators/base.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import frame as fr
from ..core.types import make_ray
from ..scene.node import SceneNodeDesc, SceneNodeTag
from ..scene.scene import SceneNode


class Camera(SceneNode):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        film_desc = desc.node("film")
        if film_desc is None:
            raise ValueError(f"camera '{desc.identifier}' has no film")
        self.film = scene.load_film(film_desc)
        filter_desc = desc.node("filter")
        if filter_desc is None:
            filter_desc = SceneNodeDesc(
                identifier="$default_filter", tag=SceneNodeTag.FILTER, impl_type="box"
            )
        self.filter = scene.load_filter(filter_desc)
        self.transform = scene.load_transform(desc.node("transform"))
        self.spp = desc.int("spp", 1024)
        self.file = desc.string("file", "render.exr")
        span = desc.float2("shutter_span", (0.0, 0.0))
        self.shutter_span = (float(span[0]), float(span[1]))
        self.shutter_samples = desc.int("shutter_samples", 0)
        # near / far clip planes at camera-space depth: `clip` = (near, far)
        # (a scalar broadcasts to both, as float2 reads it); `clip_plane` a
        # near plane, (near, 1e10). Sorted and clamped to [0, 1e10].
        clip = desc.float2("clip", None)
        if clip is None:
            clip_f = desc.float("clip", None)
            if clip_f is None:
                clip_f = desc.float("clip_plane", None)
            clip = None if clip_f is None else (float(clip_f), 1e10)
        self.clip_plane = None
        if clip is not None:
            lo, hi = sorted((max(float(clip[0]), 0.0), min(float(clip[1]), 1e10)))
            self.clip_plane = (lo, hi)

    @property
    def requires_lens_sampling(self) -> bool:
        return False

    def ray_cone(self):
        """(width0, spread): the world-space diameter of a one-pixel ray
        cone at the camera and its growth a unit of distance; the general
        fork widens it along each path for the image textures' level of
        detail (Interaction.footprint). (0, 0) here."""
        return 0.0, 0.0

    def camera_to_world(self, time=0.0) -> np.ndarray:
        if self.transform is None:
            return np.eye(4)
        return self.transform.matrix(time)

    def shutter_weights(self, n_buckets: int):
        """(times, weights) of the shutter buckets: n_buckets evenly spaced
        times over the span, equally weighted; one bucket at the span's
        start where the span is empty or n_buckets <= 1."""
        t0, t1 = self.shutter_span
        if t1 <= t0 or n_buckets <= 1:
            return [t0], [1.0]
        return list(np.linspace(t0, t1, n_buckets)), list(np.ones(n_buckets) / n_buckets)

    def _generate_ray_in_camera_space(self, pixel, u_lens):
        """pixel: (N, 2) float continuous pixel coordinates. Returns
        (origin, direction, weight) in camera space."""
        raise NotImplementedError

    def generate_rays(self, pixel_xy, u_filter, u_lens, time=0.0):
        """Returns (ray, pixel_f, weight), the camera posed at `time`."""
        offset, filter_weight = self.filter.sample(u_filter)
        pixel = pixel_xy.to(torch.float32) + 0.5 + offset
        o_c, d_c, weight = self._generate_ray_in_camera_space(pixel, u_lens)
        c2w = np.asarray(self.camera_to_world(float(time)), dtype=np.float32)

        def rot(v):
            x, y, z = v[..., 0], v[..., 1], v[..., 2]
            return torch.stack(
                [
                    float(c2w[0, 0]) * x + float(c2w[0, 1]) * y + float(c2w[0, 2]) * z,
                    float(c2w[1, 0]) * x + float(c2w[1, 1]) * y + float(c2w[1, 2]) * z,
                    float(c2w[2, 0]) * x + float(c2w[2, 1]) * y + float(c2w[2, 2]) * z,
                ],
                dim=-1,
            )

        o = rot(o_c) + torch.as_tensor(c2w[:3, 3], device=o_c.device)
        d = fr.normalize(rot(d_c))
        if self.clip_plane is not None:
            # depth -> ray parameter: camera rays leave along -z in camera
            # space, so t = depth / dz with dz the unit d_c's -z
            dz = -d_c[..., 2] / torch.clamp(fr.length(d_c), min=1e-12)
            inv = 1.0 / torch.clamp(dz, min=1e-6)
            ray = make_ray(o, d, t_min=self.clip_plane[0] * inv,
                           t_max=self.clip_plane[1] * inv)
            return ray, pixel, weight * filter_weight
        return make_ray(o, d), pixel, weight * filter_weight
