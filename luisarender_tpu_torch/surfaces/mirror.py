"""Mirror surface: Schlick-Fresnel GGX reflection.

Counterpart of luisarender_tpu/surfaces/mirror.py: Kd is the Schlick F0,
the roughness is remapped to a GGX alpha clamped at 1e-4, so smooth mirrors
are near-delta but finite and one code path covers all of them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import frame as fr
from ..core import microfacet as mf
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..textures.base import compile_tex_params, spectral_param
from .base import EVENT_REFLECT, Surface, oriented_frame, validate_sides


def roughness_row(node) -> dict:
    """Row entries of a GGX roughness parameter besides its value."""
    return {
        "roughness_channels": np.float32(node.roughness.channels if node.roughness else 1),
        "remap_roughness": np.float32(1.0 if node.remap_roughness else 0.0),
    }


def resolve_alpha(params):
    """GGX alpha (..., 2) from the row's roughness (..., 2): a scalar
    roughness texture is isotropic, remapped roughness is squared."""
    r = params["roughness"]
    iso = (params["roughness_channels"] < 1.5)[..., None]
    r = torch.where(iso, r[..., :1], r)
    remap = (params["remap_roughness"] > 0.5)[..., None]
    return torch.where(remap, mf.roughness_to_alpha(r), torch.clamp(r, min=1e-4))


def reflect_sample(params, ctx, it, wo, u, eval_local):
    """Shared sample() of the GGX reflectors: reflect wo about a visible
    normal; eval_local(wo_l, wi_l) -> (f, pdf)."""
    frame = oriented_frame(params, ctx, it, wo)
    wo_l = fr.to_local(frame, wo)
    wh = mf.ggx_sample_wh(wo_l, u, resolve_alpha(params))
    wi_l = fr.reflect(wo_l, wh)
    f, pdf = eval_local(wo_l, wi_l)
    wi = fr.to_world(frame, wi_l)
    f, pdf = validate_sides(it, frame, wo, wi, f, pdf)
    return {
        "f": f,
        "pdf": pdf,
        "wi": wi,
        "event": torch.full(pdf.shape, EVENT_REFLECT, dtype=torch.int32, device=pdf.device),
        "eta": torch.ones_like(pdf),
    }


def reflect_evaluate(params, ctx, it, wo, wi, eval_local):
    frame = oriented_frame(params, ctx, it, wo)
    f, pdf = eval_local(fr.to_local(frame, wo), fr.to_local(frame, wi))
    f, pdf = validate_sides(it, frame, wo, wi, f, pdf)
    return {"f": f, "pdf": pdf}


def ggx_reflection(wo_l, wi_l, alpha, fresnel):
    """GGX reflection lobe: (f, pdf) with fresnel(cos(wi, wh)) -> (..., C);
    |cos_i| cancels against the 4 cos_o cos_i denominator."""
    wh = fr.normalize(wo_l + wi_l)
    same = fr.same_hemisphere(wo_l, wi_l)
    cos_o = fr.abs_cos_theta(wo_l)
    cos_i = fr.abs_cos_theta(wi_l)
    d = mf.ggx_d(wh, alpha)
    g = mf.ggx_g(wo_l, wi_l, alpha)
    f = fresnel(fr.dot(wi_l, wh)) * (d * g / torch.clamp(4.0 * cos_o, min=1e-8))[..., None]
    pdf = mf.ggx_pdf(wo_l, wh, alpha) / torch.clamp(
        4.0 * torch.abs(fr.dot(wo_l, wh)), min=1e-8
    )
    valid = same & (cos_o > 1e-6) & (cos_i > 1e-6)
    return torch.where(valid[..., None], f, 0.0), torch.where(valid, pdf, 0.0)


@register(SceneNodeTag.SURFACE, "mirror", "Mirror")
class MirrorSurface(Surface):
    texture_params = (("kd", (1.0, 1.0, 1.0, 0.0), 3), ("roughness", (0.0,) * 4, 2))
    spectral_params = (("kd", "albedo"),)

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.kd = scene.load_texture(desc.node("Kd"))
        self.roughness = scene.load_texture(desc.node("roughness"))
        self.remap_roughness = desc.bool("remap_roughness", True)

    def compile(self, compiler) -> dict:
        return {**self.compile_common(compiler), **compile_tex_params(self, compiler), **roughness_row(self)}

    @staticmethod
    def _eval_local(params, ctx, swl, wo_l, wi_l):
        f0 = spectral_param(ctx, params, "kd", swl, "albedo")
        return ggx_reflection(
            wo_l, wi_l, resolve_alpha(params), lambda c: mf.fresnel_schlick(c, f0)
        )

    @staticmethod
    def evaluate(params, ctx, it, swl, wo, wi):
        return reflect_evaluate(
            params, ctx, it, wo, wi,
            lambda a, b: MirrorSurface._eval_local(params, ctx, swl, a, b),
        )

    @staticmethod
    def sample(params, ctx, it, swl, wo, u_lobe, u):
        return reflect_sample(
            params, ctx, it, wo, u,
            lambda a, b: MirrorSurface._eval_local(params, ctx, swl, a, b),
        )

    @staticmethod
    def albedo(params, ctx, it, swl):
        return spectral_param(ctx, params, "kd", swl, "albedo")

    @staticmethod
    def roughness(params, ctx, it):
        return mf.alpha_to_roughness(resolve_alpha(params))
