"""Texture mappings: uv (scale and offset) and spherical.

Counterpart of luisarender_tpu/texturemappings/impls.py. A mapping turns an
interaction into texture coordinates; a texture row stores its mapping's
type and its packed parameters (scale.xy, offset.xy).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..scene.scene import SceneNode


class TextureMapping(SceneNode):
    type_id: int = 0  # 0 = uv, 1 = spherical

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.uv_scale = desc.float2("uv_scale", (1.0, 1.0))
        self.uv_offset = desc.float2("uv_offset", (0.0, 0.0))

    def params(self) -> np.ndarray:
        """Packed (4,) parameters: scale.xy, offset.xy."""
        return np.asarray([self.uv_scale[0], self.uv_scale[1],
                           self.uv_offset[0], self.uv_offset[1]], np.float32)


@register(SceneNodeTag.TEXTURE_MAPPING, "uv", "UV")
class UVMapping(TextureMapping):
    type_id = 0


@register(SceneNodeTag.TEXTURE_MAPPING, "spherical", "Spherical")
class SphericalMapping(TextureMapping):
    type_id = 1


def apply_mapping(mapping_type, mapping_params, it):
    """mapping_type (N,) int32, mapping_params (N, 4) -> uv (N, 2). The
    spherical mapping takes the direction of the world position from the
    origin, as the reference does."""
    p = it.p
    theta = torch.arccos(torch.clamp(
        p[..., 1] / torch.clamp(torch.sqrt(torch.sum(p * p, dim=-1)), min=1e-8), -1.0, 1.0))
    phi = torch.atan2(p[..., 2], p[..., 0])
    sph_uv = torch.stack([torch.remainder(phi / (2.0 * math.pi), 1.0), theta / math.pi], dim=-1)
    base_uv = torch.where((mapping_type == 1)[..., None], sph_uv, it.uv)
    return base_uv * mapping_params[..., 0:2] + mapping_params[..., 2:4]
