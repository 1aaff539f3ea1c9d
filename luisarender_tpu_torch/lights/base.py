"""Light interface and polymorphic dispatch.

Counterpart of luisarender_tpu/lights/base.py. A light node compiles to one
parameter row per emissive instance; the light list (one entry per emissive
instance) and the flat per-light triangle alias tables live in the compiled
scene (scene/compiler.py).

`evaluate` returns the radiance towards p_from and the solid-angle pdf of
sampling that point (for MIS); `sample` picks a point on a light entry and
returns L, pdf, the point and its geometric normal; `sample_le` emits a
photon: a point, its normal, a direction and the emitted weight.
"""

from __future__ import annotations

import torch

from ..scene.scene import SceneNode
from ..surfaces.base import _select, gather_rows


class Light(SceneNode):
    # (name, kind) of each colour parameter a spectral decode reads
    spectral_params = ()

    def compile(self, compiler) -> dict:
        raise NotImplementedError

    @staticmethod
    def evaluate(params, ctx, it_light, p_from, swl):
        raise NotImplementedError

    @staticmethod
    def sample(params, ctx, entry, p_from, u, swl):
        raise NotImplementedError

    @staticmethod
    def sample_le(params, ctx, entry, u_pos, u_dir, swl):
        raise NotImplementedError


def dispatch_evaluate(ctx, it_light, p_from, swl):
    """Polymorphic light evaluation at a hit point on an emissive instance."""
    inst = ctx.arrays["instances"]
    meta = gather_rows(
        {"tag": inst["light_tag"], "idx": inst["light_index"]}, it_light.inst
    )
    tag, index = meta["tag"], meta["idx"]
    n = it_light.p.shape[0]
    result = {
        "L": it_light.p.new_zeros((n, swl.dimension)),
        "pdf": it_light.p.new_zeros((n,)),
    }
    for t, light_cls in enumerate(ctx.plan.light_types):
        mask = it_light.valid & (tag == t)
        rows = gather_rows(ctx.arrays["lights"][t], index)
        value = light_cls.evaluate(rows, ctx, it_light, p_from, swl)
        result = {k: _select(mask, value[k], result[k]) for k in result}
    return result


def dispatch_sample(ctx, entry_index, p_from, u, swl):
    """Polymorphic point sampling of the light-list entries entry_index."""
    entries = ctx.arrays["light_entries"]
    inst_id = entries["inst"][entry_index]
    inst = ctx.arrays["instances"]
    meta = gather_rows(
        {"tag": inst["light_tag"], "idx": inst["light_index"]}, inst_id
    )
    tag, index = meta["tag"], meta["idx"]
    n = p_from.shape[0]
    ng0 = torch.zeros((n, 3), dtype=p_from.dtype, device=p_from.device)
    ng0[:, 2] = 1.0
    result = {
        "L": p_from.new_zeros((n, swl.dimension)),
        "pdf": p_from.new_zeros((n,)),
        "p": p_from.new_zeros((n, 3)),
        "ng": ng0,
    }
    entry = {k: v[entry_index] for k, v in entries.items()}
    for t, light_cls in enumerate(ctx.plan.light_types):
        mask = tag == t
        rows = gather_rows(ctx.arrays["lights"][t], index)
        value = light_cls.sample(rows, ctx, entry, p_from, u, swl)
        result = {k: _select(mask, value[k], result[k]) for k in result}
    return result


def dispatch_sample_le(ctx, entry_index, u_pos, u_dir, swl):
    """Polymorphic photon emission from the light-list entries entry_index:
    every light type's sample_le on every lane, selected by the entry's
    instance's light tag (the first type's where no type claims a lane)."""
    entries = ctx.arrays["light_entries"]
    entry = {k: v[entry_index] for k, v in entries.items()}
    inst = ctx.arrays["instances"]
    tag = inst["light_tag"][entry["inst"]]
    index = inst["light_index"][entry["inst"]]
    result = None
    for t, light_cls in enumerate(ctx.plan.light_types):
        rows = gather_rows(ctx.arrays["lights"][t], index)
        value = light_cls.sample_le(rows, ctx, entry, u_pos, u_dir, swl)
        result = value if result is None else {
            k: _select(tag == t, value[k], result[k]) for k in result}
    return result
