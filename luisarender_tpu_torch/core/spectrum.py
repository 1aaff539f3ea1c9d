"""Spectral samples and the fixed sRGB spectrum model.

Counterpart of luisarender_tpu/core/spectrum.py, trimmed to the fixed
3-channel sRGB mode: wavelengths are pinned to the sRGB primaries' peaks with
pdf 1, and spectral samples are linear sRGB.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# peak response wavelengths of the sRGB primaries, in nm
SRGB_PEAK_WAVELENGTHS = (602.785, 539.285, 445.772)


class SampledWavelengths(NamedTuple):
    lam: torch.Tensor  # (N, C) wavelengths in nm
    pdf: torch.Tensor  # (N, C) sampling pdf per channel

    @property
    def dimension(self):
        return self.lam.shape[-1]


class SRGBSpectrum:
    """Fixed sRGB mode: decode is a clamp, the sample is the colour."""

    dimension = 3
    is_fixed = True

    def __init__(self):
        self._lam = {}  # device -> the (3,) wavelengths, copied there once

    def sample_wavelengths(self, n, device):
        device = torch.device(device)
        if device not in self._lam:
            self._lam[device] = torch.tensor(SRGB_PEAK_WAVELENGTHS, dtype=torch.float32,
                                             device=device)
        lam = self._lam[device].expand(n, 3)
        pdf = torch.ones((n, 3), dtype=torch.float32, device=device)
        return SampledWavelengths(lam=lam, pdf=pdf)

    def decode_albedo(self, rgb, swl):
        return torch.clamp(rgb, 0.0, 1.0)

    def decode_illuminant(self, rgb, swl):
        return torch.clamp(rgb, min=0.0)

    def srgb(self, values, swl):
        return values


def safe_div(a, b, eps=1e-20):
    """a / b with 0 where |b| <= eps; used for throughput /= pdf updates."""
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)
