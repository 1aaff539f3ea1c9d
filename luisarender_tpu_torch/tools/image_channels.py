"""Image channel utilities: RGBA -> RGB and RGBA -> transparency map.

Counterpart of luisarender_tpu/tools/image_channels.py (LuisaRender's
tools/rgba2rgb.py and rgba2trans.py), on the port's own PNG/EXR IO: drop the
alpha channel, or emit an inverted-alpha transparency texture (1 - alpha for
EXR, 255 - alpha semantics for PNG — both produced by the same float
pipeline here). PNG is decoded by utils/imageio.py png_rgba8; other 8-bit
formats (JPEG, ...) have no decoder in the port and raise.

Usage:
    python -m luisarender_tpu_torch.tools.image_channels rgb image.{exr,png}
    python -m luisarender_tpu_torch.tools.image_channels trans image.{exr,png}
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils import imageio


def _load(path):
    if path.lower().endswith(".exr"):
        return np.asarray(imageio.load_exr(path), np.float32), ".exr"
    img = np.asarray(imageio.load_image(path), np.float32)
    return img, "." + path.rsplit(".", 1)[-1].lower()


def _save(path, img, ext):
    if ext == ".exr":
        imageio.save_exr(path, np.ascontiguousarray(img))
    else:
        imageio.save_png(path, np.clip(img, 0.0, 1.0))


def rgba_to_rgb(path, out=None):
    img, ext = _load(path)
    assert img.shape[-1] == 4, f"{path} has no alpha channel"
    out = out or path[: -len(ext)] + "-rgb" + ext
    _save(out, img[..., :3], ext)
    return out


def rgba_to_trans(path, out=None):
    img, ext = _load(path)
    assert img.shape[-1] == 4, f"{path} has no alpha channel"
    out = out or path[: -len(ext)] + "-trans" + ext
    trans = 1.0 - img[..., 3]
    _save(out, np.repeat(trans[..., None], 3, axis=-1), ext)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=["rgb", "trans"])
    ap.add_argument("image")
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    fn = rgba_to_rgb if args.mode == "rgb" else rgba_to_trans
    print(fn(args.image, args.output))


if __name__ == "__main__":
    main()
