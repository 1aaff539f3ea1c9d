"""Linear sRGB and CIE XYZ.

Counterpart of the part of luisarender_tpu/core/colorspace.py that the
port reads: the sRGB (Rec.709 primaries, D65) to XYZ matrix and its
inverse, the XYZ -> linear sRGB transform the hero spectrum integrates to,
and the luminance of a linear-sRGB triple, as a torch function and as a
host numpy function.
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
