"""Diffuse area light over emissive triangles.

Counterpart of luisarender_tpu/lights/diffuse.py: alias-table triangle pick
by area, uniform barycentric point, area-to-solid-angle pdf, optional
two-sided emission and a `scale` multiplier. The emission is a texture
parameter (textures/base.py): its hoisted constant, or a texture that
varies evaluated at the light's interaction. A path that hits the light
evaluates it at its hit, ray-cone footprint included; an NEE sample at the
sampled point, its uv interpolated from the light-triangle row, with no
footprint (an image's base level), as in the reference. Photon emission
(`sample_le`) draws a point as NEE does and a cosine-weighted direction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import frame as fr
from ..core import sampling
from ..core.types import Interaction
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..textures.base import compile_tex_params, evaluate_tex_params, spectral_param
from .base import Light


@register(SceneNodeTag.LIGHT, "diffuse", "Diffuse")
class DiffuseLight(Light):
    texture_params = (("emission", (1.0, 1.0, 1.0, 0.0), 3),)
    spectral_params = (("emission", "illuminant"),)

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.emission = scene.load_texture(desc.node("emission"))
        self.scale = desc.float("scale", 1.0)
        self.two_sided = desc.bool("two_sided", False)

    def compile(self, compiler) -> dict:
        return {
            "scale": np.float32(self.scale),
            "two_sided": np.float32(1.0 if self.two_sided else 0.0),
            **compile_tex_params(self, compiler),
        }

    @staticmethod
    def _radiance(params, ctx, it_light, swl):
        """The emission at the light's interaction `it_light`, scaled."""
        params = evaluate_tex_params(ctx, params, it_light, DiffuseLight.texture_params)
        L = spectral_param(ctx, params, "emission", swl, "illuminant")
        return L * params["scale"][..., None]

    @staticmethod
    def evaluate(params, ctx, it_light, p_from, swl):
        """Radiance seen from p_from on the light's surface, and the
        solid-angle pdf of sampling that point by NEE."""
        wo = fr.normalize(p_from - it_light.p)
        cos_l = fr.dot(wo, it_light.ng)
        two_sided = params["two_sided"] > 0.5
        front = cos_l > 1e-6
        lit = front | (two_sided & (torch.abs(cos_l) > 1e-6))
        L = DiffuseLight._radiance(params, ctx, it_light, swl)
        L = torch.where(lit[..., None], L, 0.0)
        # pdf: uniform by area over this light instance's surface
        entries = ctx.arrays["light_entries"]
        entry_idx = ctx.arrays["instances"]["light_entry"][it_light.inst]
        total_area = entries["total_area"][entry_idx]
        d = p_from - it_light.p
        d2 = fr.dot(d, d)
        pdf = torch.where(
            lit, d2 / torch.clamp(torch.abs(cos_l) * total_area, min=1e-12), 0.0
        )
        return {"L": L, "pdf": pdf}

    @staticmethod
    def _pick_triangle(ctx, entry, u0):
        """Area-weighted alias pick into the packed light-triangle rows.
        Returns (row, up), up being the reused remainder of u0."""
        rows = ctx.arrays["light_tri_rows"]
        last = rows.shape[0] - 1
        off = entry["alias_offset"]
        cnt = entry["tri_count"]
        n = cnt.to(torch.float32)
        ux = u0 * n
        i0 = torch.minimum(torch.clamp(ux.to(torch.int32), min=0), cnt - 1)
        up = ux - i0.to(torch.float32)
        row0 = rows[torch.clamp(off + i0, 0, last)]
        take_alias = up >= row0[..., 18]
        i_local = torch.where(take_alias, row0[..., 19].to(torch.int32), i0)
        idx = torch.clamp(off + i_local, 0, last)
        row = torch.where(take_alias[..., None], rows[idx], row0)
        return row, up

    @staticmethod
    def sample_le(params, ctx, entry, u_pos, u_dir, swl):
        """Photon emission: a triangle picked by area, a uniform point on it
        and a cosine-weighted direction about its ng. Returns the point p,
        ng, the direction wi and the weight L * pi * area (the flux over the
        point's and the direction's pdfs, 1 / area and cos / pi)."""
        row, up = DiffuseLight._pick_triangle(ctx, entry, u_pos[..., 0])
        bary = sampling.sample_uniform_triangle(torch.stack([up, u_pos[..., 1]], dim=-1))
        b0, b1 = bary[..., 0], bary[..., 1]
        b2 = 1.0 - b0 - b1
        p = row[..., 0:3] + b1[..., None] * row[..., 3:6] + b2[..., None] * row[..., 6:9]
        ng = row[..., 9:12]
        wi = fr.to_world(fr.make_frame(ng), sampling.sample_cosine_hemisphere(u_dir))
        it_light = None
        if "emission__h" in params:
            uv = (b0[..., None] * row[..., 12:14] + b1[..., None] * row[..., 14:16]
                  + b2[..., None] * row[..., 16:18])
            zero = torch.zeros_like(b0)
            it_light = Interaction(
                valid=zero == 0.0, inst=entry["inst"], prim=torch.full_like(entry["inst"], -1),
                p=p, ng=ng, ns=ng, tangent=row[..., 3:6], uv=uv, prim_area=zero,
                back_facing=zero > 0.0,
            )
        L = DiffuseLight._radiance(params, ctx, it_light, swl)
        weight = L * (np.pi * entry["total_area"])[..., None]
        return {"p": p, "ng": ng, "wi": wi, "weight": weight}

    @staticmethod
    def sample(params, ctx, entry, p_from, u, swl):
        row, up = DiffuseLight._pick_triangle(ctx, entry, u[..., 0])
        bary = sampling.sample_uniform_triangle(torch.stack([up, u[..., 1]], dim=-1))
        b0, b1 = bary[..., 0], bary[..., 1]
        b2 = 1.0 - b0 - b1
        # p = b0 p0 + b1 p1 + b2 p2 = v0 + b1 e1 + b2 e2
        p_light = (
            row[..., 0:3] + b1[..., None] * row[..., 3:6] + b2[..., None] * row[..., 6:9]
        )
        ng = row[..., 9:12]
        wo = fr.normalize(p_from - p_light)
        cos_l = fr.dot(wo, ng)
        two_sided = params["two_sided"] > 0.5
        lit = (cos_l > 1e-6) | (two_sided & (torch.abs(cos_l) > 1e-6))
        it_light = None
        if "emission__h" in params:
            # the sampled point's interaction, for the emission's texture
            uv = (b0[..., None] * row[..., 12:14] + b1[..., None] * row[..., 14:16]
                  + b2[..., None] * row[..., 16:18])
            it_light = Interaction(
                valid=lit, inst=entry["inst"], prim=torch.full_like(entry["inst"], -1),
                p=p_light, ng=ng, ns=ng, tangent=row[..., 3:6], uv=uv,
                prim_area=torch.zeros_like(cos_l), back_facing=cos_l < 0.0,
            )
        L = DiffuseLight._radiance(params, ctx, it_light, swl)
        L = torch.where(lit[..., None], L, 0.0)
        d = p_from - p_light
        d2 = fr.dot(d, d)
        pdf = torch.where(
            lit,
            d2 / torch.clamp(torch.abs(cos_l) * entry["total_area"], min=1e-12),
            0.0,
        )
        return {"L": L, "pdf": pdf, "p": p_light, "ng": ng}
