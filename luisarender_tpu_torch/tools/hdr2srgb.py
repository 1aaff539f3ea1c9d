"""EXR (linear HDR) -> sRGB PNG with exposure, on the port's own image IO.

Counterpart of luisarender_tpu/tools/hdr2srgb.py (LuisaRender's
tools/hdr2srgb.py): load an EXR, scale by 2^exposure, apply the sRGB OETF,
write an 8-bit PNG next to the input.

Usage: python -m luisarender_tpu_torch.tools.hdr2srgb image.exr [exposure]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils import imageio


def hdr_to_srgb(img: np.ndarray, exposure: float = 0.0) -> np.ndarray:
    """Linear HDR (..., 3) -> float sRGB in [0, 1]."""
    img = np.nan_to_num(
        np.asarray(img, np.float32)[..., :3], nan=0.0, posinf=1e3, neginf=0.0
    )
    img = np.maximum(img, 0.0) * np.float32(2.0**exposure)
    srgb = np.where(
        img <= 0.00304,
        12.92 * img,
        1.055 * np.power(np.maximum(img, 1e-12), 1.0 / 2.4) - 0.055,
    )
    return np.clip(srgb, 0.0, 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("exr", help="input .exr")
    ap.add_argument("exposure", nargs="?", type=float, default=0.0)
    ap.add_argument("-o", "--output", help="output .png (default: beside input)")
    args = ap.parse_args(argv)
    assert args.exr.endswith(".exr"), "input must be an .exr"
    img = imageio.load_exr(args.exr)
    out = args.output or args.exr[:-4] + ".png"
    # save_png writes values as-is (8-bit quantize only): encode here
    imageio.save_png(out, hdr_to_srgb(img, args.exposure))
    print(out)


if __name__ == "__main__":
    main()
