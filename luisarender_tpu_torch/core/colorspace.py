"""Linear sRGB and CIE XYZ, the sRGB transfer curve and tone mapping.

Counterpart of luisarender_tpu/core/colorspace.py: the sRGB (Rec.709
primaries, D65) to XYZ matrix and its inverse, the XYZ -> linear sRGB
transform the hero spectrum integrates to, the luminance of a linear-sRGB
triple (as a torch function and as a host numpy function), the sRGB
encode / decode and the display film's tone maps (none, uncharted2,
aces), each in the reference's float32 order.
"""

from __future__ import annotations

import numpy as np
import torch

XYZ_FROM_SRGB = np.array(
    [
        [0.4123908, 0.35758434, 0.18048079],
        [0.21263901, 0.71516868, 0.07219232],
        [0.01933082, 0.11919478, 0.95053215],
    ],
    dtype=np.float32,
)
SRGB_FROM_XYZ = np.linalg.inv(XYZ_FROM_SRGB.astype(np.float64)).astype(np.float32)


def _apply_mat3(m, v):
    """m @ v for 3-vectors v (..., 3), each row summed left to right as
    the reference does."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    rows = [float(m[i, 0]) * x + float(m[i, 1]) * y + float(m[i, 2]) * z for i in range(3)]
    return torch.stack(rows, dim=-1)


def cie_xyz_to_linear_srgb(xyz):
    return _apply_mat3(SRGB_FROM_XYZ, xyz)


def cie_y_of_srgb(rgb):
    """Luminance of linear-sRGB triples (..., 3) -> (...,), summed in the
    reference's order (r, g, b)."""
    w = XYZ_FROM_SRGB[1]
    return rgb[..., 0] * float(w[0]) + rgb[..., 1] * float(w[1]) + rgb[..., 2] * float(w[2])


def cie_y_of_srgb_np(rgb) -> float:
    """Host luminance of one rgb triple, float32 arithmetic."""
    return float(cie_y_of_srgb(torch.as_tensor(np.asarray(rgb, np.float32))))


def srgb_encode(linear):
    """Linear -> sRGB gamma (the inverse EOTF)."""
    linear = torch.clamp(linear, min=0.0)
    return torch.where(
        linear <= 0.0031308,
        12.92 * linear,
        1.055 * torch.pow(torch.clamp(linear, min=1e-10), 1.0 / 2.4) - 0.055,
    )


def srgb_decode(encoded):
    """sRGB gamma -> linear (the EOTF)."""
    encoded = torch.clamp(encoded, min=0.0)
    return torch.where(
        encoded <= 0.04045,
        encoded / 12.92,
        torch.pow((encoded + 0.055) / 1.055, 2.4),
    )


# --- tone mapping: the display film's operators ---


def tonemap_none(x):
    return x


def _uncharted2_curve(v):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((v * (a * v + c * b) + d * e) / (v * (a * v + b) + d * f)) - e / f


def tonemap_uncharted2(x):
    white = torch.full((), 11.2, dtype=torch.float32, device=x.device)
    exposure_bias = 2.0
    return _uncharted2_curve(x * exposure_bias) / _uncharted2_curve(white)


def tonemap_aces(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


TONEMAP_OPERATORS = {
    "none": tonemap_none,
    "uncharted2": tonemap_uncharted2,
    "aces": tonemap_aces,
}
