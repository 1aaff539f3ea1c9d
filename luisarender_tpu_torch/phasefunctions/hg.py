"""Henyey-Greenstein phase function.

Counterpart of luisarender_tpu/phasefunctions/hg.py: the phase value (its
own pdf, as it is sampled exactly) and its sample, batched over rays with a
g a ray. Where |g| < 1e-3 the sample takes the isotropic branch; the
anisotropic one is computed with g clamped away from 0 (g_safe) and
discarded there, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import frame as fr
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..scene.scene import SceneNode

INV_4PI = 1.0 / (4.0 * math.pi)


def hg_p(cos_theta, g):
    """The phase value, which is also the pdf of hg_sample."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-8)), min=1e-8
    )


def hg_sample(wo, u, g):
    """wi sampled around wo (which points away from the scattering event)
    for u (N, 2); returns (wi, pdf)."""
    small = torch.abs(g) < 1e-3
    g_safe = torch.where(small, torch.where(g < 0, -1e-3, 1e-3), g)
    sqr_term = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * u[..., 0])
    cos_aniso = -(1.0 + g_safe * g_safe - sqr_term * sqr_term) / (2.0 * g_safe)
    cos_iso = 1.0 - 2.0 * u[..., 0]
    cos_theta = torch.clamp(torch.where(small, cos_iso, cos_aniso), -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    frame = fr.make_frame(wo)
    wi_local = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )
    return fr.to_world(frame, wi_local), hg_p(cos_theta, g)


class PhaseFunction(SceneNode):
    def compile(self, compiler) -> dict:
        raise NotImplementedError


@register(SceneNodeTag.PHASE_FUNCTION, "henyeygreenstein", "HenyeyGreenstein",
          "henyey_greenstein", "hg", "HG")
class HenyeyGreensteinPhase(PhaseFunction):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.g = desc.float("g", 0.0)

    def compile(self, compiler) -> dict:
        return {"g": np.float32(self.g)}
