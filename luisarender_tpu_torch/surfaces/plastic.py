"""Plastic surface: a Fresnel-coated diffuse substrate.

Counterpart of luisarender_tpu/surfaces/plastic.py: a GGX dielectric coat
over a Lambertian substrate with internal absorption
exp(-(1/cos_i + 1/cos_o) * sigma_a * thickness), the lobe picked by
substrate_weight = kd_lum (1 - Fo) / (kd_lum (1 - Fo) + Fo), and the pdf
mixed by the same weight. Implicitly two-sided: the local frame flips when
wo is below the surface.
"""

from __future__ import annotations

import torch

from ..core import frame as fr
from ..core import microfacet as mf
from ..core import sampling
from ..core.colorspace import cie_y_of_srgb
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..textures.base import compile_tex_params, spectral_param
from .base import EVENT_REFLECT, Surface, shading_frame, validate_sides
from .mirror import resolve_alpha, roughness_row


@register(SceneNodeTag.SURFACE, "plastic", "Plastic", "substrate", "Substrate")
class PlasticSurface(Surface):
    texture_params = (
        ("kd", (0.5, 0.5, 0.5, 0.0), 3),
        ("roughness", (0.0,) * 4, 2),
        ("sigma_a", (0.0,) * 4, 3),
        ("eta", (1.5,) * 4, 1),
        ("thickness", (1.0,) * 4, 1),
    )
    spectral_params = (("kd", "albedo"), ("sigma_a", "unbounded"))

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.kd = scene.load_texture(desc.node("Kd"))
        self.roughness = scene.load_texture(desc.node("roughness"))
        self.sigma_a = scene.load_texture(desc.node("sigma_a"))
        self.eta = scene.load_texture(desc.node("eta"))
        self.thickness = scene.load_texture(desc.node("thickness"))
        self.remap_roughness = desc.bool("remap_roughness", True)

    def compile(self, compiler) -> dict:
        return {**self.compile_common(compiler), **compile_tex_params(self, compiler), **roughness_row(self)}

    @staticmethod
    def _ctx(params, ctx, swl):
        kd = spectral_param(ctx, params, "kd", swl, "albedo")
        kd_lum = cie_y_of_srgb(params["kd"])
        sigma_a = spectral_param(ctx, params, "sigma_a", swl, "unbounded")
        sigma = sigma_a * params["thickness"][..., None]
        return kd, kd_lum, params["eta"], sigma, resolve_alpha(params)

    @staticmethod
    def substrate_weight(f_o, kd_lum):
        w = kd_lum * (1.0 - f_o)
        return torch.where(w <= 0.0, 0.0, w / torch.clamp(w + f_o, min=1e-8))

    @staticmethod
    def _eval_local(kd, eta, sigma, alpha, kd_lum, wo_l, wi_l):
        one = torch.ones_like(eta)
        cos_o = fr.abs_cos_theta(wo_l)
        cos_i = fr.abs_cos_theta(wi_l)
        same = fr.same_hemisphere(wo_l, wi_l)
        # coat
        wh = fr.normalize(wo_l + wi_l)
        d = mf.ggx_d(wh, alpha)
        g = mf.ggx_g(wo_l, wi_l, alpha)
        f_h = mf.fresnel_dielectric(fr.dot(wi_l, wh), one, eta)
        f_coat = f_h * d * g / torch.clamp(4.0 * cos_o * cos_i, min=1e-8)
        pdf_coat = mf.ggx_pdf(wo_l, wh, alpha) / torch.clamp(
            4.0 * torch.abs(fr.dot(wo_l, wh)), min=1e-8
        )
        # substrate
        f_i = mf.fresnel_dielectric(cos_i, one, eta)
        f_o = mf.fresnel_dielectric(cos_o, one, eta)
        a = torch.exp(
            -(1.0 / torch.clamp(cos_i, min=1e-6) + 1.0 / torch.clamp(cos_o, min=1e-6))[..., None]
            * sigma
        )
        f_diffuse = (
            ((1.0 - f_i) * (1.0 - f_o) / torch.clamp(eta * eta, min=1e-8))[..., None]
            * a * kd * sampling.INV_PI
        )
        pdf_diffuse = sampling.cosine_hemisphere_pdf(cos_i)
        w = PlasticSurface.substrate_weight(f_o, kd_lum)
        f = (f_coat[..., None] + f_diffuse) * cos_i[..., None]
        pdf = (1.0 - w) * pdf_coat + w * pdf_diffuse
        return torch.where(same[..., None], f, 0.0), torch.where(same, pdf, 0.0)

    @staticmethod
    def _flip(wo_l, v):
        neg = wo_l[..., 2:3] < 0.0
        return torch.cat([v[..., :2], torch.where(neg, -v[..., 2:3], v[..., 2:3])], dim=-1)

    @staticmethod
    def evaluate(params, ctx, it, swl, wo, wi):
        frame = shading_frame(params, ctx, it)
        wo_l0 = fr.to_local(frame, wo)
        wo_l = PlasticSurface._flip(wo_l0, wo_l0)
        wi_l = PlasticSurface._flip(wo_l0, fr.to_local(frame, wi))
        kd, kd_lum, eta, sigma, alpha = PlasticSurface._ctx(params, ctx, swl)
        f, pdf = PlasticSurface._eval_local(kd, eta, sigma, alpha, kd_lum, wo_l, wi_l)
        f, pdf = validate_sides(it, frame, wo, wi, f, pdf)
        return {"f": f, "pdf": pdf}

    @staticmethod
    def sample(params, ctx, it, swl, wo, u_lobe, u):
        frame = shading_frame(params, ctx, it)
        wo_l0 = fr.to_local(frame, wo)
        wo_l = PlasticSurface._flip(wo_l0, wo_l0)
        kd, kd_lum, eta, sigma, alpha = PlasticSurface._ctx(params, ctx, swl)
        f_o = mf.fresnel_dielectric(fr.abs_cos_theta(wo_l), torch.ones_like(eta), eta)
        pick_diffuse = u_lobe < PlasticSurface.substrate_weight(f_o, kd_lum)
        wi_diffuse = sampling.sample_cosine_hemisphere(u)
        wi_coat = fr.reflect(wo_l, mf.ggx_sample_wh(wo_l, u, alpha))
        wi_l = torch.where(pick_diffuse[..., None], wi_diffuse, wi_coat)
        f, pdf = PlasticSurface._eval_local(kd, eta, sigma, alpha, kd_lum, wo_l, wi_l)
        wi = fr.to_world(frame, PlasticSurface._flip(wo_l0, wi_l))
        f, pdf = validate_sides(it, frame, wo, wi, f, pdf)
        return {
            "f": f,
            "pdf": pdf,
            "wi": wi,
            "event": torch.full(pdf.shape, EVENT_REFLECT, dtype=torch.int32, device=pdf.device),
            "eta": torch.ones_like(pdf),
        }

    @staticmethod
    def albedo(params, ctx, it, swl):
        return ctx.spectrum.decode_albedo(params["kd"], swl)

    @staticmethod
    def roughness(params, ctx, it):
        return mf.alpha_to_roughness(resolve_alpha(params))
