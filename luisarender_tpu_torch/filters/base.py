"""Reconstruction filter interface with an importance-sampled LUT.

Counterpart of luisarender_tpu/filters/base.py: a 64-entry LUT of the 1D
kernel over [-r, r] is built on the host from `evaluate(x)` (normalized in
float64, stored as float32), a Vose alias table over its magnitudes
importance-samples it, and a 2D offset is the product of two 1D draws with
weight f(x) f(y) / pdf. Each camera sample then lands in exactly one pixel.
Negative lobes (mitchell, lanczos) give negative weights, carried as they
are. The tables are copied to a device once, at its first sample there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.sampling import alias_sample, build_alias_table
from ..scene.scene import SceneNode

FILTER_LUT_SIZE = 64


class Filter(SceneNode):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.radius = desc.float("radius", self.default_radius())
        n = FILTER_LUT_SIZE
        xs = (np.arange(n) + 0.5) / n
        xs = (xs * 2.0 - 1.0) * self.radius
        f = np.asarray([self.evaluate(float(x)) for x in xs], dtype=np.float64)
        # trapezoid-style normalization over the support
        integral = f.sum() * (2.0 * self.radius / n)
        f = f / max(abs(integral), 1e-12)
        self.lut = f.astype(np.float32)
        self.table = build_alias_table(np.abs(f))
        self._device_tables = {}

    def default_radius(self) -> float:
        return 1.0

    def evaluate(self, x: float) -> float:
        raise NotImplementedError

    def tables(self, device):
        """(lut, prob, alias, pdf) as tensors on `device`, copied once."""
        key = str(torch.device(device))
        cached = self._device_tables.get(key)
        if cached is None:
            cached = tuple(torch.as_tensor(a, device=device)
                           for a in (self.lut, *self.table))
            self._device_tables[key] = cached
        return cached

    def sample_1d(self, u):
        """u: (N,) -> (offset in [-r, r], weight, u_remapped)."""
        n = FILTER_LUT_SIZE
        lut, prob, alias, pdf = self.tables(u.device)
        i, pdf_i, u_rem = alias_sample(prob, alias, pdf, u)
        offset = ((i.to(torch.float32) + u_rem) / n * 2.0 - 1.0) * self.radius
        pdf_density = pdf_i * n / (2.0 * self.radius)
        weight = lut[i] / torch.clamp(pdf_density, min=1e-12)
        return offset, weight, u_rem

    def sample(self, u):
        """u: (N, 2) -> (offset (N, 2), weight (N,))."""
        ox, wx, _ = self.sample_1d(u[..., 0])
        oy, wy, _ = self.sample_1d(u[..., 1])
        return torch.stack([ox, oy], dim=-1), wx * wy
