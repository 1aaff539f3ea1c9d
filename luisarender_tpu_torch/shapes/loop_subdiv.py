"""The Loop-subdivision shape.

Counterpart of luisarender_tpu/shapes/loop_subdiv.py: a base mesh, from an
OBJ file or inline `positions` / `indices`, Loop-subdivided `level` times
(0-6) at scene load (utils/loop_subdiv.py), with area-weighted vertex
normals and no uvs.
"""

from __future__ import annotations

import numpy as np

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..utils.loop_subdiv import loop_subdivide
from ..utils.objloader import load_obj
from .base import MeshData, Shape, compute_vertex_normals


@register(SceneNodeTag.SHAPE, "loopsubdiv", "LoopSubdiv", "loop_subdiv")
class LoopSubdivShape(Shape):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.level = min(max(desc.int("level", 1), 0), 6)
        path = desc.path("file", None)
        if path is not None:
            p, t, _, _ = load_obj(path)
        else:
            positions = desc.float_list("positions", None)
            indices = desc.float_list("indices", None)
            if positions is None or indices is None:
                raise ValueError("loop_subdiv requires 'file' or 'positions'/'indices'")
            p = np.asarray(positions, np.float32).reshape(-1, 3)
            t = np.asarray(indices, np.int64).astype(np.int32).reshape(-1, 3)
        p, t = loop_subdivide(p, t, self.level)
        self._mesh = MeshData(positions=p, triangles=t, normals=compute_vertex_normals(p, t),
                              uvs=None)

    @property
    def is_mesh(self):
        return True

    def mesh(self):
        return self._mesh
