"""Hero-wavelength spectral rendering.

Counterpart of luisarender_tpu/spectra/hero.py:
- visible-wavelength importance sampling (a sech^2 pdf around 538 nm,
  PBRT-v4's curve);
- the hero rotation: C equally spaced draws in the inverse-CDF domain from
  one uniform draw, so each wavelength keeps the visible pdf;
- RGB -> spectrum with the sigmoid-polynomial model through the coefficient
  table of core/rgb2spec.py (built on the host at first use, then copied
  to each device that decodes);
- spectral -> linear sRGB through the CIE fits (core/spectrum.py).

A dispersive surface collapses a path to its hero wavelength
(integrators/common.py bounce_step, SampledWavelengths.terminate_secondary).
The `coeffs_*` / `decode_*_coeffs` pairs split a decode in two: the
compiler fits the coefficients of every constant parameter once
(scene/compiler.py hoist_spectral_coeffs) and a ray only evaluates the
sigmoid (textures/base.py spectral_param); the split decodes equal the
per-ray ones bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import cie, colorspace, rgb2spec
from ..core.spectrum import SampledWavelengths, SpectrumModel, spectral_to_xyz
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from .srgb import Spectrum

# visible-wavelength sampling constants (PBRT-v4 SampleVisible)
_VIS_A = 0.0072
_VIS_B = 538.0


def sample_visible(u):
    """u in [0, 1) -> lambda in nm, importance-sampled over the visible
    range."""
    return _VIS_B - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * u)


def visible_pdf(lam):
    x = torch.cosh(_VIS_A * (lam - _VIS_B))
    x2 = x * x
    pdf = torch.full_like(x2, 0.0039398042) / x2  # divided, as the reference does
    return torch.where((lam >= cie.SAMPLE_MIN) & (lam <= cie.SAMPLE_MAX), pdf, 0.0)


# illuminant normalization: k such that a reflector S = 1 under k * D65
# has Y = 1
_lam_grid = np.linspace(cie.VISIBLE_MIN, cie.VISIBLE_MAX, 471)
_ILLUM_NORM = float(
    cie.CIE_Y_INTEGRAL / np.trapezoid(cie.d65(_lam_grid) * cie.cie_y(_lam_grid), _lam_grid)
)


class HeroWavelengthSpectrum(SpectrumModel):
    is_fixed = False

    def __init__(self, dimension: int = 4):
        self.dimension = dimension
        self._tables = {}  # device -> the (3 R^3, 3) coefficient table there
        self._shifts = {}  # device -> the (C,) rotation offsets i / C

    def table(self, device):
        """The coefficient table on `device`, rows (k, z, y, x) flattened;
        built or loaded on the host at first use."""
        device = torch.device(device)
        t = self._tables.get(device)
        if t is None:
            host = rgb2spec.lut(rgb2spec.LUT_RES).reshape(-1, 3)
            t = self._tables[device] = torch.tensor(host, device=device)
        return t

    def sample_wavelengths(self, u):
        """u (N, 1) -> C rotated wavelengths: u_i = u + i / C mod 1, clipped
        to [1e-6, 1 - 1e-6], then lambda_i = F^-1(u_i), pdf_i its visible
        pdf."""
        c = self.dimension
        shifts = self._shifts.get(u.device)
        if shifts is None:
            host = np.arange(c, dtype=np.float32) / np.float32(c)
            shifts = self._shifts[u.device] = torch.tensor(host, device=u.device)
        ui = torch.remainder(u[..., 0:1] + shifts, 1.0)
        ui = torch.clamp(ui, 1e-6, 1.0 - 1e-6)
        lam = sample_visible(ui)
        return SampledWavelengths(lam=lam, pdf=visible_pdf(lam))

    # --- RGB -> spectrum ---
    def _coeffs(self, rgb):
        """Trilinear fetch of the sigmoid coefficients of rgb (..., 3)."""
        res = rgb2spec.LUT_RES
        rgb = torch.clamp(rgb, 0.0, 1.0)
        k = torch.argmax(rgb, dim=-1)  # the first of tied channels
        z = rgb.amax(dim=-1)
        safe_z = torch.clamp(z, min=1e-8)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        x = torch.where(k == 0, g, r) / safe_z
        y = torch.where(k == 2, g, b) / safe_z

        def axis(v):
            fv = torch.clamp(v * (res - 1), 0.0, res - 1.0)
            i0 = torch.clamp(torch.floor(fv).to(torch.int64), 0, res - 2)
            return i0, fv - i0.to(torch.float32)

        zi, zf = axis(z)
        yi, yf = axis(y)
        xi, xf = axis(x)
        t = self.table(rgb.device)
        base = ((k * res + zi) * res + yi) * res + xi

        def fetch(dz, dy, dx):
            return t[base + ((dz * res + dy) * res + dx)]

        xf, yf, zf = xf[..., None], yf[..., None], zf[..., None]
        c00 = fetch(0, 0, 0) * (1 - xf) + fetch(0, 0, 1) * xf
        c01 = fetch(0, 1, 0) * (1 - xf) + fetch(0, 1, 1) * xf
        c10 = fetch(1, 0, 0) * (1 - xf) + fetch(1, 0, 1) * xf
        c11 = fetch(1, 1, 0) * (1 - xf) + fetch(1, 1, 1) * xf
        c0 = c00 * (1 - yf) + c01 * yf
        c1 = c10 * (1 - yf) + c11 * yf
        return c0 * (1 - zf) + c1 * zf

    @staticmethod
    def _unbounded_scale(rgb):
        m = torch.clamp(rgb.amax(dim=-1), min=1e-8)
        return torch.where(m > 1.0, 2.0 * m, 1.0)

    def coeffs_albedo(self, rgb):
        return self._coeffs(rgb)

    def coeffs_unbounded(self, rgb):
        scale = self._unbounded_scale(rgb)
        return self._coeffs(rgb / scale[..., None]), scale

    def coeffs_illuminant(self, rgb):
        return self.coeffs_unbounded(torch.clamp(rgb, min=0.0))

    def decode_albedo_coeffs(self, coeffs, swl):
        return rgb2spec.eval_spectrum(coeffs, swl.lam)

    def decode_unbounded_coeffs(self, coeffs, scale, swl):
        return rgb2spec.eval_spectrum(coeffs, swl.lam) * scale[..., None]

    def decode_illuminant_coeffs(self, coeffs, scale, swl):
        return self.decode_unbounded_coeffs(coeffs, scale, swl) * cie.d65(swl.lam) * _ILLUM_NORM

    def decode_albedo(self, rgb, swl):
        return self.decode_albedo_coeffs(self.coeffs_albedo(rgb), swl)

    def decode_unbounded(self, rgb, swl):
        return self.decode_unbounded_coeffs(*self.coeffs_unbounded(rgb), swl)

    def decode_illuminant(self, rgb, swl):
        return self.decode_illuminant_coeffs(*self.coeffs_illuminant(rgb), swl)

    def srgb(self, values, swl):
        return colorspace.cie_xyz_to_linear_srgb(spectral_to_xyz(values, swl))

    def cie_y(self, values, swl):
        return spectral_to_xyz(values, swl)[..., 1]


@register(SceneNodeTag.SPECTRUM, "hero", "Hero")
class HeroSpectrumNode(Spectrum):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        dim = desc.int("dimension", 4)
        if not 1 <= dim <= 8:
            raise ValueError("hero spectrum dimension must be in [1, 8]")
        self._model = HeroWavelengthSpectrum(dimension=dim)

    def model(self):
        return self._model
