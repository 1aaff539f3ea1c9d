"""Sampler interface and the independent (hash + LCG) sampler.

Counterpart of luisarender_tpu/samplers/base.py. A sampler is stateless:
its per-path state is whatever `start` returns, carried opaque through
the integrators. For the independent sampler it is one uint32 word (an
int64 tensor, core/rng.py) seeded by xxhash32(sample index, pixel, seed);
the low-discrepancy samplers (samplers/lds.py) keep a dict of tensors.
Draws are bit-exact with the reference. Methods return (new_state, u).
"""

from __future__ import annotations

import torch

from ..core import rng
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..scene.scene import SceneNode


class Sampler(SceneNode):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.seed = desc.int("seed", 19980810)

    def start(self, pixel_xy, sample_index):
        raise NotImplementedError

    def generate_1d(self, state):
        raise NotImplementedError

    def generate_2d(self, state):
        state, u0 = self.generate_1d(state)
        state, u1 = self.generate_1d(state)
        return state, torch.stack([u0, u1], dim=-1)

    def generate_pixel_2d(self, state):
        return self.generate_2d(state)


@register(SceneNodeTag.SAMPLER, "independent", "Independent")
class IndependentSampler(Sampler):
    def start(self, pixel_xy, sample_index):
        return rng.seed_pixels(
            pixel_xy[..., 0], pixel_xy[..., 1], sample_index, self.seed
        )

    def generate_1d(self, state):
        return rng.lcg_step(state)
