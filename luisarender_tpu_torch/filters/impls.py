"""Concrete reconstruction filters: box, triangle, gaussian, mitchell, lanczos.

Counterpart of luisarender_tpu/filters/impls.py: only `evaluate(x)`
differs; the LUT and alias machinery lives in base.py. The box keeps the
reference's gather-free sampling.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from .base import FILTER_LUT_SIZE, Filter


@register(SceneNodeTag.FILTER, "box", "Box")
class BoxFilter(Filter):
    def default_radius(self):
        return 0.5

    def evaluate(self, x):
        return 1.0

    def sample_1d(self, u):
        """Every alias probability of a box LUT is 1 and its normalized value
        is 1, so the offset is (2u - 1) r and the weight 1, exactly as the
        reference's gather-free specialization computes them."""
        n = FILTER_LUT_SIZE
        ux = u * n
        i = torch.clamp(ux.to(torch.int32), 0, n - 1)
        u_rem = torch.clamp(ux - i.to(torch.float32), 0.0, 1.0 - 2.0 ** -24)
        return (u * 2.0 - 1.0) * self.radius, torch.ones_like(u), u_rem


@register(SceneNodeTag.FILTER, "triangle", "Triangle")
class TriangleFilter(Filter):
    def evaluate(self, x):
        return max(0.0, self.radius - abs(x))


@register(SceneNodeTag.FILTER, "gaussian", "Gaussian")
class GaussianFilter(Filter):
    def __init__(self, scene, desc):
        self.sigma = desc.float("sigma", 0.5)  # read before the base builds the LUT
        super().__init__(scene, desc)

    def evaluate(self, x):
        g = np.exp(-0.5 * (x / self.sigma) ** 2)
        g_r = np.exp(-0.5 * (self.radius / self.sigma) ** 2)
        return max(0.0, float(g - g_r))


@register(SceneNodeTag.FILTER, "mitchell", "Mitchell")
class MitchellFilter(Filter):
    def __init__(self, scene, desc):
        self.b = desc.float("b", 1.0 / 3.0)
        self.c = desc.float("c", 1.0 / 3.0)
        super().__init__(scene, desc)

    def default_radius(self):
        return 2.0

    def evaluate(self, x):
        b, c = self.b, self.c
        x = abs(2.0 * x / self.radius)
        if x > 2.0:
            return 0.0
        if x > 1.0:
            return (
                (-b - 6 * c) * x**3
                + (6 * b + 30 * c) * x**2
                + (-12 * b - 48 * c) * x
                + (8 * b + 24 * c)
            ) / 6.0
        return (
            (12 - 9 * b - 6 * c) * x**3 + (-18 + 12 * b + 6 * c) * x**2 + (6 - 2 * b)
        ) / 6.0


@register(SceneNodeTag.FILTER, "lanczossinc", "LanczosSinc", "lanczos_sinc", "lanczos")
class LanczosSincFilter(Filter):
    def __init__(self, scene, desc):
        self.tau = desc.float("tau", 3.0)
        super().__init__(scene, desc)

    def default_radius(self):
        return 4.0

    @staticmethod
    def _sinc(x):
        x = abs(x)
        return 1.0 if x < 1e-5 else float(np.sin(np.pi * x) / (np.pi * x))

    def evaluate(self, x):
        x = abs(x / self.radius)
        if x > 1.0:
            return 0.0
        return self._sinc(x * self.tau) * self._sinc(x)
