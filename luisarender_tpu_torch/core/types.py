"""Core batched geometric types: Ray, Hit, Interaction.

Counterpart of luisarender_tpu/core/types.py: NamedTuples of struct-of-arrays
tensors with one leading batch dimension (points and vectors (N, 3), scalars
(N,)), plus the robust ray-origin offsetting of Ray Tracing Gems ch. 6.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import frame as fr


class Ray(NamedTuple):
    origin: torch.Tensor  # (N, 3)
    direction: torch.Tensor  # (N, 3) normalized
    t_min: torch.Tensor  # (N,)
    t_max: torch.Tensor  # (N,)


def make_ray(origin, direction, t_min=0.0, t_max=math.inf):
    zero = torch.zeros_like(origin[..., 0])
    return Ray(origin=origin, direction=direction, t_min=zero + t_min,
               t_max=zero + t_max)


class Hit(NamedTuple):
    """Closest-hit record: inst -1 = miss; prim = row of the triangle table
    (the trace and shade tables share one row order); bary = (u, v)."""

    inst: torch.Tensor  # (N,) int32
    prim: torch.Tensor  # (N,) int32
    bary: torch.Tensor  # (N, 2)
    t: torch.Tensor  # (N,)


class Interaction(NamedTuple):
    """Surface interaction with shading attributes."""

    valid: torch.Tensor  # (N,) bool
    inst: torch.Tensor  # (N,) int32 instance id (-1 when not valid)
    prim: torch.Tensor  # (N,) int32
    p: torch.Tensor  # (N, 3) world position
    ng: torch.Tensor  # (N, 3) geometric normal
    ns: torch.Tensor  # (N, 3) shading normal
    tangent: torch.Tensor  # (N, 3) dpdu, not necessarily unit
    uv: torch.Tensor  # (N, 2)
    prim_area: torch.Tensor  # (N,)
    back_facing: torch.Tensor  # (N,) bool: wo opposite of ng
    # the uv-space texture footprint from ray-cone tracking (N,); None
    # without it, and image textures then read their base level
    footprint: torch.Tensor = None

    def shading_frame(self):
        return fr.frame_from_z_and_hint(self.ns, self.tangent)


_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0


def offset_ray_origin(p, n):
    of_i = (_INT_SCALE * n).to(torch.int32)
    p_bits = p.contiguous().view(torch.int32)
    p_i = torch.where(p < 0.0, p_bits - of_i, p_bits + of_i).view(torch.float32)
    return torch.where(torch.abs(p) < _ORIGIN, p + _FLOAT_SCALE * n, p_i)


def spawn_ray(it: Interaction, direction, t_max=math.inf):
    """Ray leaving a surface point, its origin offset along +-ng."""
    n = torch.where((fr.dot(it.ng, direction) >= 0.0)[..., None], it.ng, -it.ng)
    origin = offset_ray_origin(it.p, n)
    return make_ray(origin, direction, t_min=0.0, t_max=t_max)


def spawn_ray_to(it: Interaction, target_p, target_ng):
    """Shadow ray towards a target point, offset at both ends."""
    n_from = torch.where(
        (fr.dot(it.ng, target_p - it.p) >= 0.0)[..., None], it.ng, -it.ng
    )
    origin = offset_ray_origin(it.p, n_from)
    n_to = torch.where(
        (fr.dot(target_ng, origin - target_p) >= 0.0)[..., None],
        target_ng, -target_ng,
    )
    end = offset_ray_origin(target_p, n_to)
    d = end - origin
    dist = fr.length(d)
    direction = d / torch.clamp(dist, min=1e-20)[..., None]
    # shortened slightly so the light surface itself is not re-hit
    return make_ray(origin, direction, t_min=0.0, t_max=dist * (1.0 - 1e-3))
