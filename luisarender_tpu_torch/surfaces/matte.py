"""Matte surface: Lambertian / Oren-Nayar diffuse reflection.

Counterpart of luisarender_tpu/surfaces/matte.py (Kd colour, sigma roughness
in degrees; sigma == 0 is pure Lambert). Both parameters are hoisted constant
rows: `kd` (S, 3) and `sigma` (S,).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import frame as fr
from ..core import sampling
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..textures.base import compile_tex_params, spectral_param
from .base import EVENT_REFLECT, Surface, oriented_frame, validate_sides


@register(SceneNodeTag.SURFACE, "matte", "Matte")
class MatteSurface(Surface):
    texture_params = (("kd", (1.0, 1.0, 1.0, 0.0), 3), ("sigma", (0.0,) * 4, 1))
    spectral_params = (("kd", "albedo"),)

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.kd = scene.load_texture(desc.node("Kd"))
        self.sigma = scene.load_texture(desc.node("sigma"))

    def compile(self, compiler) -> dict:
        return {**self.compile_common(compiler), **compile_tex_params(self, compiler)}

    # --- device closure ---

    @staticmethod
    def _oren_nayar_ab(sigma_deg):
        sigma = sigma_deg * (np.pi / 180.0)
        s2 = sigma * sigma
        a = 1.0 - s2 / (2.0 * (s2 + 0.33))
        b = 0.45 * s2 / (s2 + 0.09)
        return a, b

    @staticmethod
    def _f_pdf(params, ctx, swl, wo_local, wi_local):
        """Local-frame Oren-Nayar f (with |cos wi|) and cosine pdf."""
        albedo = spectral_param(ctx, params, "kd", swl, "albedo")
        a, b = MatteSurface._oren_nayar_ab(params["sigma"])

        cos_o = fr.abs_cos_theta(wo_local)
        cos_i = fr.abs_cos_theta(wi_local)
        sin_o = fr.sin_theta(wo_local)
        sin_i = fr.sin_theta(wi_local)
        # max(0, cos(phi_i - phi_o))
        cos_d_phi = fr.cos_phi(wi_local) * fr.cos_phi(wo_local) + fr.sin_phi(
            wi_local
        ) * fr.sin_phi(wo_local)
        max_cos = torch.where(
            (sin_i > 1e-4) & (sin_o > 1e-4), torch.clamp(cos_d_phi, min=0.0), 0.0
        )
        sin_alpha = torch.where(cos_o > cos_i, sin_i, sin_o)
        tan_beta = torch.where(
            cos_o > cos_i,
            sin_o / torch.clamp(cos_o, min=1e-6),
            sin_i / torch.clamp(cos_i, min=1e-6),
        )
        on = a + b * max_cos * sin_alpha * tan_beta
        same_side = fr.same_hemisphere(wo_local, wi_local)
        f = albedo * (sampling.INV_PI * on * cos_i)[..., None]
        pdf = sampling.cosine_hemisphere_pdf(cos_i)
        f = torch.where(same_side[..., None], f, 0.0)
        pdf = torch.where(same_side, pdf, 0.0)
        return f, pdf

    @staticmethod
    def evaluate(params, ctx, it, swl, wo, wi):
        frame = oriented_frame(params, ctx, it, wo)
        wo_l = fr.to_local(frame, wo)
        wi_l = fr.to_local(frame, wi)
        f, pdf = MatteSurface._f_pdf(params, ctx, swl, wo_l, wi_l)
        f, pdf = validate_sides(it, frame, wo, wi, f, pdf)
        return {"f": f, "pdf": pdf}

    @staticmethod
    def sample(params, ctx, it, swl, wo, u_lobe, u):
        frame = oriented_frame(params, ctx, it, wo)
        wo_l = fr.to_local(frame, wo)
        wi_l = sampling.sample_cosine_hemisphere(u)
        flip = torch.tensor([1.0, 1.0, -1.0], dtype=wi_l.dtype, device=wi_l.device)
        wi_l = torch.where(wo_l[..., 2:3] < 0.0, wi_l * flip, wi_l)
        f, pdf = MatteSurface._f_pdf(params, ctx, swl, wo_l, wi_l)
        wi = fr.to_world(frame, wi_l)
        f, pdf = validate_sides(it, frame, wo, wi, f, pdf)
        return {
            "f": f,
            "pdf": pdf,
            "wi": wi,
            "event": torch.full(pdf.shape, EVENT_REFLECT, dtype=torch.int32,
                                device=pdf.device),
            "eta": torch.ones_like(pdf),
        }

    @staticmethod
    def albedo(params, ctx, it, swl):
        return spectral_param(ctx, params, "kd", swl, "albedo")
