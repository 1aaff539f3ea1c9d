"""Spectral samples and the spectrum model interface.

Counterpart of luisarender_tpu/core/spectrum.py. A spectral sample is a
tensor (N, C), C the model's static dimension; `SampledWavelengths` holds
each lane's C wavelengths and their sampling pdfs (0 marks a terminated
wavelength). The fixed sRGB model pins the wavelengths to the sRGB
primaries' peaks with pdf 1, and its samples are linear sRGB; the hero
model (spectra/hero.py) samples C wavelengths a path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cie, colorspace

# peak response wavelengths of the sRGB primaries, in nm
SRGB_PEAK_WAVELENGTHS = (602.785, 539.285, 445.772)


class SampledWavelengths(NamedTuple):
    lam: torch.Tensor  # (N, C) wavelengths in nm
    pdf: torch.Tensor  # (N, C) sampling pdf per channel (0: terminated)

    @property
    def dimension(self):
        return self.lam.shape[-1]

    def terminate_secondary(self):
        """Collapse to the hero wavelength after a dispersive event: the
        hero keeps pdf / C, the others 0."""
        c = self.lam.shape[-1]
        if c == 1:
            return self
        pdf = torch.cat([self.pdf[..., :1] / c, torch.zeros_like(self.pdf[..., 1:])], dim=-1)
        return SampledWavelengths(lam=self.lam, pdf=pdf)

    def secondary_terminated(self):
        if self.lam.shape[-1] == 1:
            return torch.ones(self.lam.shape[:-1], dtype=torch.bool, device=self.lam.device)
        return (self.pdf[..., 1:] == 0.0).all(dim=-1)


class SpectrumModel:
    """Host RGB -> a spectral sample at sampled wavelengths, and back."""

    dimension: int = 3
    is_fixed: bool = True

    def sample_wavelengths(self, u):
        """u (N, 1) uniform draws -> SampledWavelengths (N, C)."""
        raise NotImplementedError

    def decode_albedo(self, rgb, swl):
        raise NotImplementedError

    def decode_unbounded(self, rgb, swl):
        raise NotImplementedError

    def decode_illuminant(self, rgb, swl):
        raise NotImplementedError

    def srgb(self, values, swl):
        """A spectral sample (N, C) -> linear sRGB (N, 3)."""
        raise NotImplementedError

    def cie_y(self, values, swl):
        raise NotImplementedError


class SRGBSpectrum(SpectrumModel):
    """Fixed sRGB mode: decode is a clamp, the sample is the colour."""

    dimension = 3
    is_fixed = True

    def __init__(self):
        self._lam = {}  # device -> the (3,) wavelengths, copied there once

    def sample_wavelengths(self, u):
        """The fixed wavelengths for each row of u (N, 1); its values are
        not read."""
        n, device = u.shape[0], u.device
        if device not in self._lam:
            self._lam[device] = torch.tensor(SRGB_PEAK_WAVELENGTHS, dtype=torch.float32,
                                             device=device)
        lam = self._lam[device].expand(n, 3)
        pdf = torch.ones((n, 3), dtype=torch.float32, device=device)
        return SampledWavelengths(lam=lam, pdf=pdf)

    def decode_albedo(self, rgb, swl):
        return torch.clamp(rgb, 0.0, 1.0)

    def decode_unbounded(self, rgb, swl):
        return rgb

    def decode_illuminant(self, rgb, swl):
        return torch.clamp(rgb, min=0.0)

    def srgb(self, values, swl):
        return values

    def cie_y(self, values, swl):
        return colorspace.cie_y_of_srgb(values)


def spectrum_average(values):
    """Mean over the spectral dimension."""
    return values.mean(dim=-1)


def spectrum_max(values):
    return values.amax(dim=-1)


def safe_div(a, b, eps=1e-20):
    """a / b with 0 where |b| <= eps; used for throughput /= pdf updates."""
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def spectral_to_xyz(values, swl):
    """Monte Carlo estimate of XYZ from spectral samples at swl:
    mean_i CIE(lambda_i) s_i / pdf_i over the integral of ybar."""
    xyz_bar = cie.cie_xyz(swl.lam)  # (N, C, 3)
    w = safe_div(values, swl.pdf)
    xyz = (xyz_bar * w[..., None]).mean(dim=-2)
    return xyz / cie.CIE_Y_INTEGRAL
