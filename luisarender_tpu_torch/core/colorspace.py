"""Linear-sRGB luminance.

Counterpart of the part of luisarender_tpu/core/colorspace.py that the
ported surfaces and the fused kernel's host tables read: the CIE Y row of
the sRGB (Rec.709 primaries, D65) to XYZ matrix, and the luminance of a
linear-sRGB triple, as a torch function and as a host numpy function.
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


def cie_y_of_srgb(rgb):
    """Luminance of linear-sRGB triples (..., 3) -> (...,), summed in the
    reference's order (r, g, b)."""
    w = XYZ_FROM_SRGB[1]
    return rgb[..., 0] * float(w[0]) + rgb[..., 1] * float(w[1]) + rgb[..., 2] * float(w[2])


def cie_y_of_srgb_np(rgb) -> float:
    """Host luminance of one rgb triple, float32 arithmetic."""
    return float(cie_y_of_srgb(torch.as_tensor(np.asarray(rgb, np.float32))))
