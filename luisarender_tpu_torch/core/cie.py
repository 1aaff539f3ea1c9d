"""CIE 1931 colour matching functions and the standard illuminant D65.

Counterpart of luisarender_tpu/core/cie.py: the analytic multi-lobe
Gaussian fits of Wyman, Sloan & Shirley (JCGT 2013) for the matching
functions, and D65 approximated by a 6503.6 K Planckian radiator,
normalized to 1 at 560 nm. numpy in, numpy out (host tables: the
RGB-to-spectrum basis, the illuminant normalization); torch in, torch out
(per-ray decodes and the integration to XYZ), in the reference's float32
operation order. Wavelengths are in nanometres.
"""

from __future__ import annotations

import numpy as np
import torch

VISIBLE_MIN = 360.0
VISIBLE_MAX = 830.0
# the range the hero spectrum's wavelength sampling covers
SAMPLE_MIN = 360.0
SAMPLE_MAX = 830.0


def _is_np(x):
    return isinstance(x, (np.ndarray, np.generic, float, int))


def _gauss_piecewise(x, mu, s1, s2):
    """A Gaussian with different left and right widths (Wyman eq. 1)."""
    if _is_np(x):
        s = np.where(x < mu, s1, s2)
        t = (x - mu) / s
        return np.exp(-0.5 * t * t)
    s = torch.where(x < mu, s1, s2)
    t = (x - mu) / s
    return torch.exp(-0.5 * t * t)


def cie_x(lam):
    return (
        1.056 * _gauss_piecewise(lam, 599.8, 37.9, 31.0)
        + 0.362 * _gauss_piecewise(lam, 442.0, 16.0, 26.7)
        - 0.065 * _gauss_piecewise(lam, 501.1, 20.4, 26.2)
    )


def cie_y(lam):
    return 0.821 * _gauss_piecewise(lam, 568.8, 46.9, 40.5) + 0.286 * _gauss_piecewise(
        lam, 530.9, 16.3, 31.1
    )


def cie_z(lam):
    return 1.217 * _gauss_piecewise(lam, 437.0, 11.8, 36.0) + 0.681 * _gauss_piecewise(
        lam, 459.0, 26.0, 13.8
    )


def cie_xyz(lam):
    """(...,) nm -> (..., 3) CIE XYZ matching function values."""
    parts = [cie_x(lam), cie_y(lam), cie_z(lam)]
    return np.stack(parts, axis=-1) if _is_np(lam) else torch.stack(parts, dim=-1)


# integral of ybar over the visible range (the spectral -> XYZ
# normalization), trapezoid on a 1 nm grid in float64
_lam_grid = np.linspace(VISIBLE_MIN, VISIBLE_MAX, 471)


def _np_gauss(x, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return np.exp(-0.5 * ((x - mu) / s) ** 2)


_ybar = 0.821 * _np_gauss(_lam_grid, 568.8, 46.9, 40.5) + 0.286 * _np_gauss(
    _lam_grid, 530.9, 16.3, 31.1
)
CIE_Y_INTEGRAL = float(np.trapezoid(_ybar, _lam_grid))


def _pow5(x):
    """x**5 as XLA's integer power takes it: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def blackbody(lam_nm, temperature):
    """Planck's law (relative spectral radiance), lambda in nm."""
    lam = lam_nm * 1e-9
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23
    if _is_np(lam):
        return (2.0 * h * c * c) / (lam**5 * (np.exp(h * c / (lam * kb * temperature)) - 1.0))
    # a Python number over a tensor as XLA divides it (torch's own form
    # multiplies by the reciprocal)
    e = torch.exp(_rdiv(h * c, lam * kb * temperature))
    return _rdiv(2.0 * h * c * c, _pow5(lam) * (e - 1.0))


def _rdiv(num, t):
    return torch.full_like(t, num) / t


_D65_REF = {}  # device -> blackbody(560 nm) as a 0-dim float32 tensor there


def d65(lam_nm):
    """Approximate relative SPD of CIE D65, normalized to 1 at 560 nm; the
    reference value is taken in float32 on either side."""
    t = 6503.6
    val = blackbody(lam_nm, t)
    if _is_np(lam_nm):
        return val / blackbody(np.float32(560.0), t)
    ref = _D65_REF.get(lam_nm.device)
    if ref is None:
        ref = blackbody(torch.tensor(560.0, dtype=torch.float32, device=lam_nm.device), t)
        _D65_REF[lam_nm.device] = ref
    return val / ref
