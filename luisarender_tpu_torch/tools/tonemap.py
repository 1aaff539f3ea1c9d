"""Tonemap an HDR image (EXR/PFM/HDR) to PNG or EXR.

Counterpart of luisarender_tpu/tools/tonemap.py (LuisaRender's
tools/tonemap.py): exposure scale + tone mapping operator (none /
uncharted2 / aces, the same set the display film offers) + sRGB encode,
with the port's torch operators (core/colorspace.py) on the card unless the
caller asks for the CPU, and the port's own image IO.

Usage:
    python -m luisarender_tpu_torch.tools.tonemap in.exr out.png \
        [--tonemap aces] [--exposure 0.0] [--hdr]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import colorspace
from ..core.device import resolve_device
from ..utils import imageio


def tonemap_image(
    image: np.ndarray, operator: str = "aces", exposure: float = 0.0, device=None
) -> np.ndarray:
    """image: (H, W, 3) linear float. Returns tone-mapped LINEAR values,
    computed on `device` (default: the first CUDA card)."""
    if operator not in colorspace.TONEMAP_OPERATORS:
        raise ValueError(
            f"unknown tone mapping '{operator}'; "
            f"choose {sorted(colorspace.TONEMAP_OPERATORS)}"
        )
    dev = resolve_device(device)
    scaled = torch.as_tensor(np.asarray(image, np.float32), device=dev) * (2.0 ** exposure)
    return colorspace.TONEMAP_OPERATORS[operator](scaled).cpu().numpy()


def load_any(path: str) -> np.ndarray:
    if path.lower().endswith(".exr"):
        return imageio.load_exr(path)
    return imageio.load_image(path)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--tonemap", default="aces")
    ap.add_argument("--exposure", type=float, default=0.0)
    ap.add_argument(
        "--hdr", action="store_true",
        help="write linear EXR instead of sRGB-encoded PNG",
    )
    args = ap.parse_args(argv)

    img = np.asarray(load_any(args.input), np.float32)[..., :3]
    mapped = tonemap_image(img, args.tonemap, args.exposure, device=device)
    if args.hdr or args.output.lower().endswith(".exr"):
        imageio.save_exr(args.output, mapped)
    else:
        encoded = colorspace.srgb_encode(torch.as_tensor(mapped, device=resolve_device(device)))
        imageio.save_png(args.output, encoded.cpu().numpy())
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
