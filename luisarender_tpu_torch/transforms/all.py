"""Transform nodes: identity, matrix, srt, view (look-at), stack and lerp.

Counterpart of luisarender_tpu/transforms/all.py. Transforms are host-side:
`matrix(time)` returns a numpy 4x4 that the scene compiler bakes into
world-space geometry at a shutter time. `lerp` keyframes matrices over
time (the source of motion blur); `stack` composes transforms, the last
listed applying first.
"""

from __future__ import annotations

import numpy as np

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..scene.scene import SceneNode


class Transform(SceneNode):
    @property
    def is_static(self) -> bool:
        return True

    @property
    def is_identity(self) -> bool:
        return False

    def matrix(self, time: float = 0.0) -> np.ndarray:
        raise NotImplementedError


@register(SceneNodeTag.TRANSFORM, "identity", "Identity")
class IdentityTransform(Transform):
    @property
    def is_identity(self):
        return True

    def matrix(self, time=0.0):
        return np.eye(4, dtype=np.float64)


@register(SceneNodeTag.TRANSFORM, "matrix", "Matrix")
class MatrixTransform(Transform):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        m = desc.float_list("m", None)
        if m is None or len(m) != 16:
            raise ValueError("matrix transform expects 16 values (row-major)")
        self._m = np.asarray(m, dtype=np.float64).reshape(4, 4)

    def matrix(self, time=0.0):
        return self._m


def _rotation(axis, angle_deg):
    axis = np.asarray(axis, dtype=np.float64)
    n = axis / max(np.linalg.norm(axis), 1e-12)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = n
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    r = np.eye(3) * c + (1 - c) * np.outer(n, n) + s * k
    m = np.eye(4)
    m[:3, :3] = r
    return m


@register(SceneNodeTag.TRANSFORM, "srt", "SRT")
class SRTTransform(Transform):
    """scale, rotate(axis, angle in degrees), translate: T @ R @ S."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.scale = desc.float3("scale", (1.0, 1.0, 1.0))
        rot = desc.float4("rotate", (0.0, 0.0, 1.0, 0.0))
        self.rotate_axis = rot[:3]
        self.rotate_angle = rot[3]
        self.translate = desc.float3("translate", (0.0, 0.0, 0.0))

    def matrix(self, time=0.0):
        s = np.diag([*self.scale, 1.0])
        r = _rotation(self.rotate_axis, self.rotate_angle)
        t = np.eye(4)
        t[:3, 3] = self.translate
        return t @ r @ s


@register(SceneNodeTag.TRANSFORM, "view", "View")
class ViewTransform(Transform):
    """Look-at camera-to-world: position/front/up (or target)."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.position = np.asarray(desc.float3("origin", desc.float3("position", (0, 0, 0))))
        self.front = np.asarray(desc.float3("front", (0, 0, -1)), dtype=np.float64)
        self.up = np.asarray(desc.float3("up", (0, 1, 0)), dtype=np.float64)
        target = desc.float3("target", None)
        if target is not None:
            self.front = np.asarray(target, dtype=np.float64) - self.position

    def matrix(self, time=0.0):
        f = self.front / max(np.linalg.norm(self.front), 1e-12)
        r = np.cross(f, self.up)
        r = r / max(np.linalg.norm(r), 1e-12)
        u = np.cross(r, f)
        m = np.eye(4)
        # camera space: x right, y up, looking down -z
        m[:3, 0] = r
        m[:3, 1] = u
        m[:3, 2] = -f
        m[:3, 3] = self.position
        return m


@register(SceneNodeTag.TRANSFORM, "stack", "Stack")
class StackTransform(Transform):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.transforms = [scene.load_transform(t) for t in desc.node_list("transforms")]

    @property
    def is_static(self):
        return all(t.is_static for t in self.transforms)

    def matrix(self, time=0.0):
        m = np.eye(4)
        # the product in list order: the last listed applies first
        for t in self.transforms:
            m = m @ t.matrix(time)
        return m


@register(SceneNodeTag.TRANSFORM, "lerp", "Lerp")
class LerpTransform(Transform):
    """Matrices keyframed at `time_points`, interpolated linearly between
    neighbours and clamped to the first and last outside them."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.transforms = [scene.load_transform(t) for t in desc.node_list("transforms")]
        self.time_points = desc.float_list("time_points", None)
        if self.time_points is None or len(self.time_points) != len(self.transforms):
            raise ValueError("lerp transform needs matching time_points/transforms")

    @property
    def is_static(self):
        return len(self.transforms) <= 1

    def matrix(self, time=0.0):
        tp = self.time_points
        if time <= tp[0]:
            return self.transforms[0].matrix(time)
        if time >= tp[-1]:
            return self.transforms[-1].matrix(time)
        i = int(np.searchsorted(tp, time)) - 1
        w = (time - tp[i]) / max(tp[i + 1] - tp[i], 1e-12)
        return (1.0 - w) * self.transforms[i].matrix(time) + w * self.transforms[
            i + 1].matrix(time)
