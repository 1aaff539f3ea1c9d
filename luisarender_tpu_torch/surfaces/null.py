"""Null (pass-through) surface.

Counterpart of luisarender_tpu/surfaces/null.py: no lobes and no
parameters. The scene compiler gives an instance with a null surface no
surface tag (-1), so a path that reaches it ends there after adding its
emission; it still blocks shadow rays when it carries a light (a light
panel, as in testing.mesh_heavy).
"""

from __future__ import annotations

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from .base import Surface


@register(SceneNodeTag.SURFACE, "null", "Null")
class NullSurface(Surface):
    texture_params = ()

    @property
    def is_null(self) -> bool:
        return True

    def compile(self, compiler) -> dict:
        return self.compile_common(compiler)
