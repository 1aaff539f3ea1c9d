"""Procedural textures: checkerboard, swizzle, scale (multiply).

Counterpart of luisarender_tpu/textures/procedural.py. Child textures are
evaluated through `evaluate_param` at depth + 1 (textures/base.py
MAX_NEST bounds the nesting, as in the reference); swizzle and scale fold
to a host constant when their base does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..texturemappings.impls import apply_mapping
from .base import Texture, compile_tex_param, compile_tex_params, evaluate_param, gather_rows


@register(SceneNodeTag.TEXTURE, "checkerboard", "Checkerboard")
class CheckerboardTexture(Texture):
    nests = True
    texture_params = (("on", (1.0, 1.0, 1.0, 1.0), 4), ("off", (0.0, 0.0, 0.0, 1.0), 4))

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.on = scene.load_texture(desc.node("on"))
        self.off = scene.load_texture(desc.node("off"))
        self.uv_scale = desc.float2("uv_scale", (1.0, 1.0))
        self.mapping = scene.load_texture_mapping(desc.node("mapping"))

    @property
    def channels(self):
        return max(self.on.channels if self.on else 4, self.off.channels if self.off else 4)

    def compile(self, compiler) -> int:
        m_params = (self.mapping.params() if self.mapping is not None
                    else np.asarray([1, 1, 0, 0], np.float32))
        row = {
            "uv_scale": np.asarray(self.uv_scale, np.float32),
            "mapping_type": np.int32(self.mapping.type_id if self.mapping else 0),
            "mapping_params": m_params,
        }
        row.update(compile_tex_params(self, compiler))
        return compiler.register_texture_row(CheckerboardTexture, row)

    @staticmethod
    def evaluate_rows(ctx, index, it, depth=0):
        r = gather_rows(ctx.arrays["textures"]["checkerboard"], index)
        uv = apply_mapping(r["mapping_type"], r["mapping_params"], it)
        uv = uv * r["uv_scale"]
        cell = torch.remainder((torch.floor(uv[..., 0]) + torch.floor(uv[..., 1])).to(torch.int32), 2)
        on = evaluate_param(ctx, r, "on", it, default=(1.0, 1.0, 1.0, 1.0), depth=depth + 1)
        off = evaluate_param(ctx, r, "off", it, default=(0.0, 0.0, 0.0, 1.0), depth=depth + 1)
        return torch.where((cell == 0)[..., None], on, off)


_SWIZZLE_CODES = {"x": 0, "y": 1, "z": 2, "w": 3, "r": 0, "g": 1, "b": 2, "a": 3}


@register(SceneNodeTag.TEXTURE, "swizzle", "Swizzle")
class SwizzleTexture(Texture):
    nests = True
    texture_params = (("base", (0.0, 0.0, 0.0, 0.0), 4),)

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        base = desc.node("base")
        if base is None:
            raise ValueError("swizzle texture requires 'base'")
        self.base_tex = scene.load_texture(base)
        sw = desc.string("swizzle", "xyzw").lower()
        if not 1 <= len(sw) <= 4 or any(c not in _SWIZZLE_CODES for c in sw):
            raise ValueError(f"invalid swizzle '{sw}'")
        self._channels = len(sw)
        self.codes = np.asarray([_SWIZZLE_CODES[c] for c in sw] + [3] * (4 - len(sw)), np.int32)

    @property
    def channels(self):
        return self._channels

    def evaluate_static(self):
        b = self.base_tex.evaluate_static()
        if b is None:
            return None
        b = np.asarray(b, np.float32).reshape(-1)
        b = np.concatenate([b, np.zeros(4 - b.shape[0], np.float32)])
        return b[self.codes]

    def compile(self, compiler) -> int:
        row = {"codes": self.codes}
        compile_tex_param(compiler, self.base_tex, self.texture_params[0][1], row, "base")
        return compiler.register_texture_row(SwizzleTexture, row)

    @staticmethod
    def evaluate_rows(ctx, index, it, depth=0):
        r = gather_rows(ctx.arrays["textures"]["swizzle"], index)
        base = evaluate_param(ctx, r, "base", it, default=(0.0, 0.0, 0.0, 0.0), depth=depth + 1)
        return torch.gather(base, -1, r["codes"].long())


@register(SceneNodeTag.TEXTURE, "scale", "Scale", "multiply", "Multiply")
class ScaleTexture(Texture):
    """base * scale."""

    nests = True
    texture_params = (("base", (1.0, 1.0, 1.0, 1.0), 4),)

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        base = desc.node("base")
        if base is None:
            raise ValueError("scale texture requires 'base'")
        self.base_tex = scene.load_texture(base)
        s = desc.float_list("scale", [1.0])
        if len(s) == 1:
            s = s * 4
        self.s = np.asarray((list(s) + [1.0] * 4)[:4], np.float32)

    @property
    def channels(self):
        return self.base_tex.channels

    def evaluate_static(self):
        b = self.base_tex.evaluate_static()
        if b is None:
            return None
        b = np.asarray(b, np.float32).reshape(-1)
        b = np.concatenate([b, np.ones(4 - b.shape[0], np.float32)])
        return b * self.s

    def compile(self, compiler) -> int:
        row = {"scale": self.s}
        compile_tex_param(compiler, self.base_tex, self.texture_params[0][1], row, "base")
        return compiler.register_texture_row(ScaleTexture, row)

    @staticmethod
    def evaluate_rows(ctx, index, it, depth=0):
        r = gather_rows(ctx.arrays["textures"]["scale"], index)
        base = evaluate_param(ctx, r, "base", it, default=(1.0, 1.0, 1.0, 1.0), depth=depth + 1)
        return base * r["scale"]
