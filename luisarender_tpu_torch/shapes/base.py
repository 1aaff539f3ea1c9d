"""Shape interface: meshes and shape DAG nodes.

Counterpart of luisarender_tpu/shapes/base.py. A shape is a concrete mesh or
a DAG node with children (groups, instances); its surface, light,
transform and two-sidedness are baked into the instance table by the scene
compiler. `visible: false` hides an instance from the two-level trace only
(scene/compiler.py; a flattened scene ignores it, as the reference's
does). Media and the shadow-terminator / intersection-offset factors are
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..scene.scene import SceneNode


class MeshData(NamedTuple):
    positions: np.ndarray  # (V, 3) float32, object space
    triangles: np.ndarray  # (T, 3) int32
    normals: Optional[np.ndarray]  # (V, 3) float32 or None
    uvs: Optional[np.ndarray]  # (V, 2) float32 or None


class Shape(SceneNode):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.surface = scene.load_surface(desc.node("surface"))
        self.light = scene.load_light(desc.node("light"))
        self.medium = scene.load_medium(desc.node("medium"))
        self.transform = scene.load_transform(desc.node("transform"))
        self.visible = desc.bool("visible", True)
        self.two_sided = desc.bool("two_sided", None)

    @property
    def is_mesh(self) -> bool:
        return False

    def mesh(self) -> MeshData:
        raise NotImplementedError

    def children(self) -> list:
        return []


def compute_vertex_normals(positions: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for meshes without authored normals."""
    fn = np.cross(
        positions[triangles[:, 1]] - positions[triangles[:, 0]],
        positions[triangles[:, 2]] - positions[triangles[:, 0]],
    )
    vn = np.zeros_like(positions)
    for k in range(3):
        np.add.at(vn, triangles[:, k], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)
