"""Constant-value texture.

Counterpart of luisarender_tpu/textures/constant.py: a row of the constant
table; parameters that name it are hoisted to its value at compile.
"""

from __future__ import annotations

import numpy as np

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from .base import Texture, gather_rows


@register(SceneNodeTag.TEXTURE, "constant", "Constant")
class ConstantTexture(Texture):
    texture_params = ()

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        v = desc.float_list("v", [1.0])
        if len(v) > 4:
            raise ValueError("constant texture accepts at most 4 channels")
        rgba = list(v) + [0.0] * (4 - len(v))
        # channels as the reference counts them: a single scalar broadcasts
        # to rgb, like float3(v), and counts as 3
        self._channels = max(len(v), 1)
        if len(v) == 1:
            rgba = [v[0], v[0], v[0], 0.0]
            self._channels = 3
        self.value = np.asarray(rgba, dtype=np.float32)

    @property
    def channels(self):
        return self._channels

    def evaluate_static(self):
        return self.value

    def compile(self, compiler) -> int:
        return compiler.register_texture_row(ConstantTexture, {"value": self.value})

    @staticmethod
    def evaluate_rows(ctx, index, it):
        return gather_rows(ctx.arrays["textures"]["constant"], index)["value"]
