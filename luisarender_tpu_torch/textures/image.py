"""Image texture on the shared atlas, with mips and ray-cone LOD.

Counterpart of luisarender_tpu/textures/image.py. Every image
texture of a scene, with its 2x2 box mip chain, is shelf-packed into one
(H, W, 4) atlas (scene/compiler.py _pack_atlas); a texture row carries its
image's id, the uv transform, the wrap mode, the mapping and a scale. A
lookup is bilinear inside the level's atlas rect with edge clamping, its
four corners fetched in one index op; where the interaction carries a
ray-cone footprint, the level of detail is log2 of the footprint in
texels, and the two nearest levels blend (trilinear, eight corners in one
index op). The gather's backward is PyTorch's own indexing backward, a
scatter-add into the atlas (`index_put_` with accumulate), as the
reference's custom VJP is an XLA scatter; as there, the coarser level's
blend passes no gradient unless LR_TEX_GRAD_FULLMIP=1 (read at each
lookup). LDR files are sRGB-decoded at load (utils/imageio.py).
As in the reference, `encoding: "gamma"` is the only encoding that
changes a loaded image (pow(rgb, gamma), a new atlas entry); any other
encoding, "linear" included, keeps the decoded image.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..texturemappings.impls import apply_mapping
from ..utils import imageio
from .base import Texture, gather_rows

WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2
_WRAP_MODES = {"repeat": WRAP_REPEAT, "clamp": WRAP_CLAMP, "mirror": WRAP_MIRROR}

def atlas_gather(atlas, ys, xs):
    """The atlas texels at rows ys and columns xs (int, any shape): one
    index op, whose backward scatter-adds into the atlas."""
    return atlas[ys.long(), xs.long()]


# loaded images by path: a file used by several textures loads once and
# keeps one atlas entry
_IMAGE_CACHE: dict = {}


def _as_rgba(img: np.ndarray) -> np.ndarray:
    """A loaded image as (H, W, 4) float32, padded as the reference pads:
    grey to (g, g, g, 1), two or three channels with zeros."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] < 4:
        pad = np.zeros(img.shape[:2] + (4 - img.shape[-1],), np.float32)
        if img.shape[-1] == 1:
            img = np.concatenate([img, img, img, pad[..., :1] * 0 + 1], -1)
        else:
            img = np.concatenate([img, pad], -1)
    return np.ascontiguousarray(img[..., :4], np.float32)


def image_row(image_id, uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0), wrap=WRAP_REPEAT,
              scale=(1.0, 1.0, 1.0), mapping=None, mapping_type=None):
    """An image texture's row (the sky's too): `mapping` a texture mapping
    node, or None for the uv mapping (mapping_type 1: the spherical one)
    with unit scale and no offset."""
    if mapping_type is None:
        mapping_type = mapping.type_id if mapping is not None else 0
    return {
        "image_id": np.int32(image_id),
        "uv_scale": np.asarray(uv_scale, np.float32),
        "uv_offset": np.asarray(uv_offset, np.float32),
        "wrap": np.int32(wrap),
        "scale": np.asarray(list(scale) + [1.0], np.float32),
        "mapping_type": np.int32(mapping_type),
        "mapping_params": (mapping.params() if mapping is not None
                           else np.asarray([1, 1, 0, 0], np.float32)),
    }


@register(SceneNodeTag.TEXTURE, "image", "Image")
class ImageTexture(Texture):
    texture_params = ()
    reads_footprint = True

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        path = desc.path("file", None)
        if path is None:
            raise ValueError("image texture requires 'file'")
        encoding = desc.string("encoding", None)
        if path not in _IMAGE_CACHE:
            _IMAGE_CACHE[path] = _as_rgba(imageio.load_image(path))
        self.image = _IMAGE_CACHE[path]
        if encoding == "gamma":
            gamma = desc.float("gamma", 2.2)
            self.image = np.concatenate(
                [np.power(np.maximum(self.image[..., :3], 0.0), gamma), self.image[..., 3:]], -1)
        self.uv_scale = desc.float2("uv_scale", (1.0, 1.0))
        self.uv_offset = desc.float2("uv_offset", (0.0, 0.0))
        self.wrap = _WRAP_MODES.get(desc.string("wrap", "repeat").lower(), WRAP_REPEAT)
        self.mapping = scene.load_texture_mapping(desc.node("mapping"))
        self.scale = desc.float3("scale", (1.0, 1.0, 1.0))

    @property
    def channels(self):
        return 4

    def rasterize(self):
        """The radiance grid a spherical environment samples."""
        return self.image[..., :3] * np.asarray(self.scale, np.float32)

    def compile(self, compiler) -> int:
        return compiler.register_texture_row(ImageTexture, image_row(
            compiler.register_atlas_image(self.image), self.uv_scale, self.uv_offset,
            self.wrap, self.scale, self.mapping))

    @staticmethod
    def _corners(rect, u, v):
        """The four bilinear corners' atlas rows and columns (4, N) each,
        clamped inside `rect` (N, 4) x, y, w, h, and the weights fx, fy."""
        x = u * rect[..., 2].to(torch.float32) - 0.5
        y = v * rect[..., 3].to(torch.float32) - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0i = x0.to(torch.int32)
        y0i = y0.to(torch.int32)
        xs = torch.stack([x0i, x0i + 1, x0i, x0i + 1])
        ys = torch.stack([y0i, y0i, y0i + 1, y0i + 1])
        xs = torch.minimum(torch.clamp(xs, min=0), rect[..., 2] - 1) + rect[..., 0]
        ys = torch.minimum(torch.clamp(ys, min=0), rect[..., 3] - 1) + rect[..., 1]
        return ys, xs, fx, fy

    @staticmethod
    def _blend(vals, fx, fy):
        return (vals[0] * (1 - fx) * (1 - fy) + vals[1] * fx * (1 - fy)
                + vals[2] * (1 - fx) * fy + vals[3] * fx * fy)

    @staticmethod
    def evaluate_rows(ctx, index, it):
        arrays = ctx.arrays
        atlas = arrays["texture_atlas"]
        rects = arrays["texture_atlas_rects"]
        r = gather_rows(arrays["textures"]["image"], index)
        uv = apply_mapping(r["mapping_type"], r["mapping_params"], it)
        uv = uv * r["uv_scale"] + r["uv_offset"]

        def wrap(x, mode):
            rep = torch.remainder(x, 1.0)
            clp = torch.clamp(x, 0.0, 1.0)
            mir = 1.0 - torch.abs(torch.remainder(x, 2.0) - 1.0)
            return torch.where(mode == WRAP_REPEAT, rep, torch.where(mode == WRAP_CLAMP, clp, mir))

        u = wrap(uv[..., 0], r["wrap"])
        v = wrap(uv[..., 1], r["wrap"])
        mip = arrays["texture_atlas_mips"][r["image_id"].long()]
        base = mip[..., 0]
        n_levels = mip[..., 1]
        base_rect = rects[base.long()]
        if it.footprint is None:
            ys, xs, fx, fy = ImageTexture._corners(base_rect, u, v)
            return ImageTexture._blend(atlas_gather(atlas, ys, xs), fx, fy) * r["scale"]
        # the level of detail: the footprint in texels of the base level
        foot_u = it.footprint * torch.abs(r["uv_scale"][..., 0])
        foot_v = it.footprint * torch.abs(r["uv_scale"][..., 1])
        texels = torch.maximum(foot_u * base_rect[..., 2].to(torch.float32),
                               foot_v * base_rect[..., 3].to(torch.float32))
        lod = torch.log2(torch.clamp(texels, min=1e-8))
        lod = torch.minimum(torch.clamp(lod, min=0.0), n_levels.to(torch.float32) - 1.0)
        l0 = torch.floor(lod).to(torch.int32)
        l1 = torch.minimum(l0 + 1, n_levels - 1)
        fl = (lod - l0.to(torch.float32))[..., None]
        ys0, xs0, fx0, fy0 = ImageTexture._corners(rects[(base + l0).long()], u, v)
        ys1, xs1, fx1, fy1 = ImageTexture._corners(rects[(base + l1).long()], u, v)
        vals = atlas_gather(atlas, torch.cat([ys0, ys1]), torch.cat([xs0, xs1]))
        v0 = ImageTexture._blend(vals[:4], fx0, fy0)
        v1 = ImageTexture._blend(vals[4:], fx1, fy1)
        if os.environ.get("LR_TEX_GRAD_FULLMIP", "0") == "0":
            # the reference's default: gradients through the finer level only
            v1 = v1.detach()
        return (v0 * (1.0 - fl) + v1 * fl) * r["scale"]
