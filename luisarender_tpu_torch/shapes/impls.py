"""Concrete shapes: the inline mesh, the file mesh, the sphere, and the
group and instance nodes.

Counterpart of luisarender_tpu/shapes/impls.py. A mesh placed many times
(by instances of one shape node, by file, by sphere subdivision) resolves
to one MeshData object, which the two-level compiler counts as one unique
mesh (scene/compiler.py keys them on id()).
"""

from __future__ import annotations

import numpy as np

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..utils.loop_subdiv import loop_subdivide
from ..utils.objloader import load_obj
from ..utils.plyloader import load_ply
from .base import MeshData, Shape


@register(SceneNodeTag.SHAPE, "inlinemesh", "InlineMesh", "inline_mesh")
class InlineMesh(Shape):
    """Vertices/indices given directly in the scene description."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        positions = desc.float_list("positions", None)
        indices = desc.float_list("indices", None)
        if positions is None or indices is None:
            raise ValueError("inline mesh requires 'positions' and 'indices'")
        p = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
        t = np.asarray(indices, dtype=np.int64).astype(np.int32).reshape(-1, 3)
        normals = desc.float_list("normals", None)
        n = (
            np.asarray(normals, dtype=np.float32).reshape(-1, 3)
            if normals is not None
            else None
        )
        uvs = desc.float_list("uvs", None)
        uv = (
            np.asarray(uvs, dtype=np.float32).reshape(-1, 2)
            if uvs is not None
            else None
        )
        self._mesh = MeshData(positions=p, triangles=t, normals=n, uvs=uv)

    @property
    def is_mesh(self):
        return True

    def mesh(self):
        return self._mesh


# file meshes by (path, flip_uv, subdivision): a scene that places one mesh
# many times loads it once
_MESH_CACHE: dict = {}


@register(SceneNodeTag.SHAPE, "mesh", "Mesh")
class ObjMesh(Shape):
    """File mesh: OBJ (utils/objloader.py) or PLY ascii / binary
    (utils/plyloader.py), by the file's extension. `flip_uv` mirrors v;
    `subdivision: N` applies N levels of Loop subdivision
    (utils/loop_subdiv.py), which drops the authored normals and uvs (the
    compiler then computes vertex normals)."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        path = desc.path("file", None)
        if path is None:
            raise ValueError("mesh shape requires 'file'")
        self.flip_uv = desc.bool("flip_uv", False)
        self.subdivision = max(desc.int("subdivision", 0), 0)
        key = (path, self.flip_uv, self.subdivision)
        if key not in _MESH_CACHE:
            if str(path).lower().endswith(".ply"):
                p, t, n, uv = load_ply(path)
            else:
                p, t, n, uv = load_obj(path)
            if uv is not None and self.flip_uv:
                uv = np.stack([uv[:, 0], 1.0 - uv[:, 1]], axis=-1)
            if self.subdivision > 0:
                p, t = loop_subdivide(p, t, self.subdivision)
                n, uv = None, None
            _MESH_CACHE[key] = MeshData(positions=p, triangles=t, normals=n, uvs=uv)
        self._mesh = _MESH_CACHE[key]

    @property
    def is_mesh(self):
        return True

    def mesh(self):
        return self._mesh


_SPHERE_MESHES: dict = {}


def icosphere(subdivision: int):
    """Subdivided icosahedron on the unit sphere: (positions (V, 3) float32,
    triangles (T, 3) int32), T = 20 * 4^subdivision."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivision):
        edge_mid: dict = {}
        verts_list = list(verts)
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                edge_mid[key] = len(verts_list)
                verts_list.append(m / np.linalg.norm(m))
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts.astype(np.float32), faces.astype(np.int32)


@register(SceneNodeTag.SHAPE, "sphere", "Sphere")
class SphereShape(Shape):
    """The unit sphere, placed by its transform. By default the scene
    compiler intersects it as an exact quadric; `analytic: false`, an
    emissive sphere or a transform that is not a similarity use the
    subdivided icosphere mesh instead (scene/compiler.py analytic_sphere),
    with the same uv parameterization either way."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.subdivision = min(max(desc.int("subdivision", 4), 0), 8)
        self.analytic = desc.bool("analytic", True)
        if self.subdivision not in _SPHERE_MESHES:
            p, t = icosphere(self.subdivision)
            theta = np.arccos(np.clip(p[:, 2], -1, 1))
            phi = np.arctan2(p[:, 1], p[:, 0])
            uv = np.stack([(phi / (2 * np.pi)) % 1.0, theta / np.pi], axis=-1)
            _SPHERE_MESHES[self.subdivision] = MeshData(
                positions=p, triangles=t, normals=p.copy(), uvs=uv.astype(np.float32)
            )
        self._mesh = _SPHERE_MESHES[self.subdivision]

    @property
    def is_mesh(self):
        return True

    def mesh(self):
        return self._mesh


@register(SceneNodeTag.SHAPE, "group", "Group")
class GroupShape(Shape):
    """Its `shapes`, under its own transform, surface, light and visibility."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self._children = [scene.load_shape(s) for s in desc.node_list("shapes")]

    def children(self):
        return self._children


@register(SceneNodeTag.SHAPE, "instance", "Instance")
class InstanceShape(Shape):
    """One more placement of its `shape` (a node shared by reference)."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        ref = desc.node("shape")
        if ref is None:
            raise ValueError("instance shape requires 'shape'")
        self._children = [scene.load_shape(ref)]

    def children(self):
        return self._children
