"""Environment (infinite light) interface.

Counterpart of luisarender_tpu/environments/base.py: `evaluate(wi)` and
`sample(p, u)` under a world rotation. An environment compiles its own
tables (`device_arrays`, numpy, placed on the device with the rest of the
scene as arrays["environment"]); the light sampler treats it as a
pseudo-light (lightsamplers/uniform.py).
"""

from __future__ import annotations

import numpy as np

from ..scene.scene import SceneNode


class Environment(SceneNode):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.transform = scene.load_transform(desc.node("transform"))
        self.scale = desc.float("scale", 1.0)

    @property
    def is_null(self) -> bool:
        return False

    def rotation(self, time=0.0) -> np.ndarray:
        if self.transform is None:
            return np.eye(3, dtype=np.float32)
        return np.asarray(self.transform.matrix(time)[:3, :3], np.float32)

    def compile(self, compiler):
        raise NotImplementedError

    def device_arrays(self) -> dict:
        return {}

    # --- device side: ctx is the CompiledScene ---
    def evaluate(self, ctx, wi_world, swl):
        """-> {L: (N, C), pdf: (N,)}, pdf being sample()'s, for MIS."""
        raise NotImplementedError

    def sample(self, ctx, p, u, swl):
        """-> {wi: (N, 3), L: (N, C), pdf: (N,)}."""
        raise NotImplementedError
