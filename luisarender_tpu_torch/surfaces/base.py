"""Surface (BSDF) interface and scene-static polymorphic dispatch.

Counterpart of luisarender_tpu/surfaces/base.py. A host node compiles one
parameter row per instance; the device closures are static `evaluate` /
`sample` methods over gathered rows. `dispatch` is the reference's
compute-all form: every surface type present runs on every lane and a tag
mask selects (its tag-sorted alternative is off by default there and is not
ported). Texture parameters arrive hoisted in the rows; where a row names a
texture that varies, `dispatch` evaluates it at the hit first
(textures/base.py evaluate_tex_params).

Conventions: `f` includes |cos(theta_i)|; pdf is in solid angle and 0 marks
an invalid sample; wo points away from the surface.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import frame as fr
from ..scene.scene import SceneNode
from ..textures.base import compile_tex_param, evaluate_tex_params

# surface event codes
EVENT_REFLECT = 0
EVENT_ENTER = 1
EVENT_EXIT = 2
EVENT_THROUGH = 3

# the wrapper textures every surface may name (the reference's NormalMap and
# Opacity wrappers as data): (name, default rgba, channels)
NORMAL_MAP_PARAM = ("normal_map", (0.5, 0.5, 1.0, 0.0), 3)
ALPHA_PARAM = ("alpha", (1.0, 1.0, 1.0, 1.0), 1)


class Surface(SceneNode):
    # (name, kind) of each colour parameter a spectral decode reads
    # (textures/base.py spectral_param)
    spectral_params = ()
    # why the surface cannot render under a spectrum that is not fixed, or ""
    fixed_spectrum_only = ""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.normal_map = scene.load_texture(desc.node("normal_map"))
        self.alpha = scene.load_texture(desc.node("alpha"))
        self.two_sided = desc.bool("two_sided", False)

    def __init_subclass__(cls, **kw):
        # the normal map is a texture parameter of every surface; a class
        # that declares its own texture_params gets it in front
        super().__init_subclass__(**kw)
        own = cls.__dict__.get("texture_params")
        if own and not any(name == "normal_map" for name, _, _ in own):
            cls.texture_params = (NORMAL_MAP_PARAM,) + tuple(own)

    def compile_common(self, compiler) -> dict:
        """The row entries every surface carries: `two_sided`, and the
        wrapper textures as the reference compiles them, with a presence
        flag each (`normal_map__p`, `alpha__p`: 1 where the surface names
        the texture, a constant included), compiled first as the reference
        compiles them. The normal map is also one of the class's
        texture_params, so dispatch evaluates it at the hit; alpha is read
        by nothing on the device, as in the reference."""
        row = {"two_sided": np.float32(1.0 if self.two_sided else 0.0)}
        for name, default, channels in (NORMAL_MAP_PARAM, ALPHA_PARAM):
            tex = getattr(self, name)
            compile_tex_param(compiler, tex, default, row, name, channels)
            row[name + "__p"] = np.float32(tex is not None)
        return row

    def compile(self, compiler) -> dict:
        raise NotImplementedError

    @staticmethod
    def evaluate(params, ctx, it, swl, wo, wi):
        raise NotImplementedError

    @staticmethod
    def sample(params, ctx, it, swl, wo, u_lobe, u):
        raise NotImplementedError

    @staticmethod
    def albedo(params, ctx, it, swl):
        return torch.zeros(it.p.shape[:-1] + (swl.dimension,), dtype=torch.float32,
                           device=it.p.device)

    @staticmethod
    def roughness(params, ctx, it):
        return torch.ones(it.p.shape[:-1] + (2,), dtype=torch.float32, device=it.p.device)

    @staticmethod
    def eta_value(params, ctx, it, swl):
        """The closure's relative index of refraction, 1 where it does not
        refract (the transmissive half-vector shift of integrators/gpt.py
        reads it)."""
        return torch.ones(it.p.shape[:-1], dtype=torch.float32, device=it.p.device)


def shading_frame(params, ctx, it):
    """The shading frame, tangent-space normal mapped where the row names a
    normal map and the plan has any: the mapped normal (value * 2 - 1,
    normalised, to world space) and the tangent rebuild the frame. A type
    none of whose rows names one has no `normal_map__p` column
    (scene/compiler.py drop_unused); the reference rebuilds its frame from
    the same normal and tangent, which gives the same frame."""
    frame = it.shading_frame()
    if "normal_map__p" in params and ctx.plan.any_normal_maps:
        n_local = fr.normalize(params["normal_map"] * 2.0 - 1.0)
        has = (params["normal_map__p"] > 0.5)[..., None]
        n_world = fr.normalize(fr.to_world(frame, n_local))
        n = torch.where(has, n_world, frame["n"])
        frame = fr.frame_from_z_and_hint(n, it.tangent)
    return frame


def oriented_frame(params, ctx, it, wo):
    """Shading frame, flipped toward wo when the surface is two-sided."""
    frame = shading_frame(params, ctx, it)
    flip = ((fr.dot(wo, frame["n"]) < 0.0) & (params["two_sided"] > 0.5))[..., None]
    return {
        "s": frame["s"],
        "t": torch.where(flip, -frame["t"], frame["t"]),
        "n": torch.where(flip, -frame["n"], frame["n"]),
    }


def validate_sides(it, frame, wo, wi, f, pdf):
    """Zero f/pdf where the geometric and shading normals disagree on
    whether wi is a reflection or a transmission of wo."""
    ns = frame["n"]
    ng = it.ng
    refl_geo = fr.dot(wo, ng) * fr.dot(wi, ng) > 0.0
    refl_sha = fr.dot(wo, ns) * fr.dot(wi, ns) > 0.0
    ok = refl_geo == refl_sha
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def gather_rows(params, index):
    """Per-lane parameter rows: params[k][index] for every column, with the
    index clamped into the table like the reference's row fetch."""
    out = {}
    for k, v in params.items():
        out[k] = v[torch.clamp(index, 0, v.shape[0] - 1)]
    return out


def _select(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())),
                       new, old)


def dispatch(ctx, it, method, *args, init):
    """Evaluate `method` for every surface type present; select by tag.
    init: per-lane defaults for lanes no type claims, a dict of tensors or,
    for a method that returns one (albedo, roughness), a tensor."""
    inst = ctx.arrays["instances"]
    meta = gather_rows(
        {"tag": inst["surface_tag"], "idx": inst["surface_index"]}, it.inst
    )
    tag, index = meta["tag"], meta["idx"]
    result = init
    for t, surf_cls in enumerate(ctx.plan.surface_types):
        mask = it.valid & (tag == t)
        rows = gather_rows(ctx.arrays["surfaces"][t], index)
        rows = evaluate_tex_params(ctx, rows, it, surf_cls.texture_params)
        value = getattr(surf_cls, method)(rows, ctx, it, *args)
        if isinstance(result, dict):
            result = {k: _select(mask, value[k], result[k]) for k in result}
        else:
            result = _select(mask, value, result)
    return result


def any_dispersive(ctx) -> bool:
    """Static: does any surface type of the plan disperse?"""
    return any(hasattr(cls, "is_dispersive_rows") for cls in ctx.plan.surface_types)


def dispersive_mask(ctx, it):
    """Per lane: did it hit a dispersive surface (a glass with a non-zero
    Cauchy B)? It drives swl.terminate_secondary (integrators/common.py)."""
    inst = ctx.arrays["instances"]
    meta = gather_rows({"tag": inst["surface_tag"], "idx": inst["surface_index"]}, it.inst)
    tag, index = meta["tag"], meta["idx"]
    mask = torch.zeros(it.inst.shape, dtype=torch.bool, device=it.inst.device)
    for t, surf_cls in enumerate(ctx.plan.surface_types):
        fn = getattr(surf_cls, "is_dispersive_rows", None)
        if fn is None:
            continue
        rows = gather_rows(ctx.arrays["surfaces"][t], index)
        mask = torch.where(it.valid & (tag == t), fn(rows, ctx), mask)
    return mask
