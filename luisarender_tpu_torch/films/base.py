"""Film interface and the color film.

Counterpart of luisarender_tpu/films/base.py. The accumulation buffer is an
(H, W, 4) float32 tensor: RGB sum plus the effective sample count. A
sample of every pixel enters as a dense add with relative clamping and NaN
rejection (`accumulate_image`); the wavefront pool adds a run of
consecutive pixels (`accumulate_linear`), and shuffled samples scatter
(`accumulate_scatter`), both clamped to `clamp`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import trace
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..scene.scene import SceneNode


class Film(SceneNode):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.resolution = tuple(desc.int2("resolution", (1024, 1024)))

    def prepare(self, device):
        w, h = self.resolution
        return torch.zeros((h, w, 4), dtype=torch.float32, device=device)


@register(SceneNodeTag.FILM, "color", "Color")
class ColorFilm(Film):
    """Clamp relative to the sample count, exposure scale, NaN rejection."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.clamp = desc.float("clamp", 256.0)
        exposure = desc.float_list("exposure", [0.0])
        if len(exposure) == 1:
            exposure = exposure * 3
        self.exposure = np.asarray(exposure[:3], dtype=np.float32)

    def accumulate_image(self, accum, radiance, sample_weight):
        """radiance (H, W, 3) linear sRGB of one sample; sample_weight (H, W)."""
        with trace.span("lr.film"):
            finite = torch.isfinite(radiance).all(dim=-1, keepdim=True)
            effective_spp = accum[..., 3:4]
            bound = self.clamp * torch.clamp(effective_spp, min=1.0)
            clamped = torch.minimum(torch.clamp(radiance, min=0.0), bound)
            contrib = torch.where(finite, clamped * sample_weight[..., None], 0.0)
            count = torch.where(finite[..., 0], sample_weight, 0.0)
            return accum + torch.cat([contrib, count[..., None]], dim=-1)

    def _values(self, radiance, sample_weight):
        """(N, 4) rows to add: radiance clamped to [0, clamp] times its
        weight, and the weight; 0 where a channel is not finite."""
        finite = torch.isfinite(radiance).all(dim=-1)
        clamped = torch.clamp(radiance, 0.0, self.clamp)
        contrib = torch.where(finite[..., None], clamped * sample_weight[..., None], 0.0)
        count = torch.where(finite, sample_weight, 0.0)
        return torch.cat([contrib, count[..., None]], dim=-1)

    def accumulate_linear(self, accum, start, radiance, sample_weight):
        """A new buffer with the samples of consecutive flat pixels start,
        start + 1, ... added (the wavefront pool's pixel-pinned slots):
        radiance (N, 3), sample_weight (N,); rows past the last pixel are
        dropped. The clamp is `clamp` itself, not relative to the count."""
        with trace.span("lr.film"):
            h, w = accum.shape[0], accum.shape[1]
            vals = self._values(radiance, sample_weight)
            m = min(vals.shape[0], h * w - start)
            out = accum.clone()
            out.view(h * w, 4)[start:start + m] += vals[:m]
            return out

    def accumulate_scatter(self, accum, pixel_ids, radiance, sample_weight):
        """A new buffer with samples of any pixels added: pixel_ids (N, 2)
        int (x, y), clamped to the film; radiance (N, 3); sample_weight
        (N,). Lanes whose count is 0 (dead or not finite) are dropped, not
        sent to a pixel."""
        with trace.span("lr.film"):
            h, w = accum.shape[0], accum.shape[1]
            vals = self._values(radiance, sample_weight)
            y = torch.clamp(pixel_ids[..., 1].to(torch.int64), 0, h - 1)
            x = torch.clamp(pixel_ids[..., 0].to(torch.int64), 0, w - 1)
            # dead lanes go to a row past the film's, cut off after the add
            idx = torch.where(vals[..., 3] <= 0.0, h * w, y * w + x)
            flat = torch.cat([accum.reshape(h * w, 4), accum.new_zeros((1, 4))])
            return flat.index_add(0, idx, vals)[: h * w].reshape(h, w, 4)

    def develop(self, accum):
        """-> (H, W, 3) linear sRGB average with exposure applied."""
        with trace.span("lr.develop"):
            count = torch.clamp(accum[..., 3:4], min=1e-8)
            rgb = accum[..., :3] / count
            scale = torch.exp2(torch.as_tensor(self.exposure, device=accum.device))
            return rgb * scale
