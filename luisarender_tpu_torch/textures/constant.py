"""Constant-value texture.

Counterpart of luisarender_tpu/textures/constant.py.
"""

from __future__ import annotations

import numpy as np

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from .base import Texture


@register(SceneNodeTag.TEXTURE, "constant", "Constant")
class ConstantTexture(Texture):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        v = desc.float_list("v", [1.0])
        if len(v) > 4:
            raise ValueError("constant texture accepts at most 4 channels")
        rgba = list(v) + [0.0] * (4 - len(v))
        # channels as the reference counts them: a single scalar broadcasts
        # to rgb, like float3(v), and counts as 3
        self.channels = max(len(v), 1)
        if len(v) == 1:
            rgba = [v[0], v[0], v[0], 0.0]
            self.channels = 3
        self.value = np.asarray(rgba, dtype=np.float32)

    def evaluate_static(self):
        return self.value
