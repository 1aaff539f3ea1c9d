"""Layered surface: a dielectric coat over any inner surface.

Counterpart of luisarender_tpu/surfaces/layered.py, in its two modes:

- closed form (the default): the coat's GGX reflection lobe plus the inner
  lobe through the coat's directional Fresnel transmittances, Beer-Lambert
  absorption in the slab, and the series of coat / inner interreflections
  in closed form;
- `stochastic: true` (`max_depth` K, default 10): the reference's walk
  between the inner surface and the coat's underside, unrolled K times:
  at each inner vertex a connection to the exit direction, then a
  continuation sampled from the inner surface and weighted by the
  internal Fresnel reflectance. Its random numbers are a hash of the hit
  and the two directions (xxhash32 of float32 bit patterns, then pcg3d),
  so evaluation stays a pure function of its inputs.

Like mix, the host node compiles to a generated type, one an (inner class,
K) pair, with the inner surface's row inline under the prefix `i_`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import frame as fr
from ..core import microfacet as mf
from ..core import rng
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..textures.base import compile_tex_param, spectral_param
from .base import EVENT_REFLECT, Surface
from .mirror import resolve_alpha
from .mix import device_class, prefixed, split, type_token

COAT_PARAMS = (
    ("roughness", (0.0,) * 4, 2),
    ("eta", (1.5,) * 4, 1),
    ("sigma_a", (0.0,) * 4, 3),
    ("thickness", (1.0,) * 4, 1),
)

_MONO_CACHE: dict = {}


def float_bits(x):
    """The uint32 words of float32 values' bit patterns (not their values)."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & rng.MASK32


def walk_seed(p, wo_l, wi_l):
    """The walk's hash of the hit point and the local directions, its sums
    taken in float32 in the reference's order."""
    return rng.xxhash32(
        float_bits(p[..., 0]),
        float_bits(p[..., 1] + p[..., 2]),
        float_bits(wo_l[..., 0] + 2.0 * wi_l[..., 1]),
        float_bits(wo_l[..., 2] + 3.0 * wi_l[..., 0]),
    )


def monomorphized(inner_cls, walk_k: int = 0):
    """The generated surface type of a coat over inner_cls; walk_k > 0 is
    the stochastic walk's depth, 0 the closed form."""
    key = (inner_cls, walk_k)
    if key in _MONO_CACHE:
        return _MONO_CACHE[key]
    tex_i, spec_i = prefixed(inner_cls, "i_")

    class LayeredMono(Surface):
        generated = True
        inner = inner_cls
        WALK_K = walk_k
        impl_names = (f"layered<{type_token(inner_cls)},k={walk_k}>",)
        texture_params = COAT_PARAMS + tex_i
        spectral_params = (("sigma_a", "unbounded"),) + spec_i
        fixed_spectrum_only = inner_cls.fixed_spectrum_only

        @staticmethod
        def _coat(params, wo_l, wi_l):
            """The coat's reflection lobe (f without the cosine), its pdf
            and the coat's index."""
            alpha = resolve_alpha(params)
            eta = params["eta"]
            wh = fr.normalize(wo_l + wi_l)
            wh = torch.where(fr.cos_theta(wh)[..., None] < 0, -wh, wh)
            d = mf.ggx_d(wh, alpha)
            g = mf.ggx_g(wo_l, wi_l, alpha)
            f_h = mf.fresnel_dielectric(fr.dot(wo_l, wh), torch.ones_like(eta), eta)
            cos_o = fr.abs_cos_theta(wo_l)
            cos_i = fr.abs_cos_theta(wi_l)
            f = f_h * d * g / torch.clamp(4.0 * cos_o * cos_i, min=1e-7)
            pdf = mf.ggx_pdf(wo_l, wh, alpha) / torch.clamp(
                4.0 * torch.abs(fr.dot(wo_l, wh)), min=1e-7)
            return f, pdf, eta

        @staticmethod
        def _sigma(params, ctx, swl):
            sigma_a = spectral_param(ctx, params, "sigma_a", swl, "unbounded")
            return sigma_a * params["thickness"][..., None]

        @staticmethod
        def _transmittances(params, ctx, swl, wo_l, wi_l, eta, a_inner):
            """The inner lobe's factor: the coat's transmittances both
            ways, the slab's absorption, and the interreflection series'
            closed form 1 / (eta^2 (1 - R_int a_inner A^2))."""
            cos_o = fr.abs_cos_theta(wo_l)
            cos_i = fr.abs_cos_theta(wi_l)
            t_o = 1.0 - mf.fresnel_dielectric(cos_o, torch.ones_like(eta), eta)
            t_i = 1.0 - mf.fresnel_dielectric(cos_i, torch.ones_like(eta), eta)
            sigma = LayeredMono._sigma(params, ctx, swl)
            a = torch.exp(
                -(1.0 / torch.clamp(cos_i, min=1e-4) + 1.0 / torch.clamp(cos_o, min=1e-4))[
                    ..., None] * sigma)
            r_int = mf.fresnel_dielectric_integral(eta)
            eta2 = torch.clamp(eta * eta, min=1.0)
            comp = 1.0 / (eta2[..., None]
                          * torch.clamp(1.0 - r_int[..., None] * a_inner * a * a, min=0.05))
            return (t_o * t_i)[..., None] * a * comp

        @staticmethod
        def _walk_inner(params, ctx, it, swl, frame, wo_l, wi_l, eta, inner_p):
            """The inner lobe of f(wo, wi) by the K-bounce walk in the slab
            (local directions; every leg pays Beer-Lambert absorption)."""
            sigma = LayeredMono._sigma(params, ctx, swl)

            def absorb(w):
                return torch.exp(-sigma / torch.clamp(fr.abs_cos_theta(w), min=1e-4)[..., None])

            z = torch.zeros_like(wo_l)
            z[..., 2] = 1.0
            inv_eta = 1.0 / eta
            # both ends refracted into the slab
            ok_o, w_down = fr.refract(wo_l, z, inv_eta)
            ok_i, w_i_in = fr.refract(wi_l, z, inv_eta)
            t_o = 1.0 - mf.fresnel_dielectric(fr.cos_theta(wo_l), torch.ones_like(eta), eta)
            t_i = 1.0 - mf.fresnel_dielectric(fr.cos_theta(wi_l), torch.ones_like(eta), eta)
            exit_dir = -w_i_in  # upward; it refracts out to wi
            a_exit = absorb(exit_dir)
            # the inner f is in the slab's solid-angle measure: the exit
            # connection carries cos_i / (eta^2 cos_i')
            exit_jac = fr.abs_cos_theta(wi_l) / (
                eta * eta * torch.clamp(fr.abs_cos_theta(w_i_in), min=1e-4))
            seed = walk_seed(it.p, wo_l, wi_l)
            n, c = wo_l.shape[0], swl.dimension
            f_acc = torch.zeros((n, c), dtype=torch.float32, device=wo_l.device)
            beta = t_o[..., None] * torch.ones((n, c), dtype=torch.float32, device=wo_l.device)
            alive = ok_o & ok_i & (fr.cos_theta(wo_l) > 0) & (fr.cos_theta(wi_l) > 0)
            flip = torch.tensor([1.0, 1.0, -1.0], dtype=torch.float32, device=wo_l.device)
            exit_world = fr.to_world(frame, exit_dir)
            w = w_down
            for k in range(LayeredMono.WALK_K):
                beta = beta * absorb(w)
                # the inner vertex connected to the exit direction
                e = inner_cls.evaluate(inner_p, ctx, it, swl, fr.to_world(frame, -w), exit_world)
                f_acc = f_acc + torch.where(
                    alive[..., None], beta * e["f"] * a_exit * (t_i * exit_jac)[..., None], 0.0)
                if k == LayeredMono.WALK_K - 1:
                    break
                # continuation: sample the inner surface, then reflect at
                # the coat's underside weighted by its Fresnel reflectance
                b0, b1, b2 = rng.pcg3d(seed, k + 1, seed ^ 0x9E3779B9)
                u_lobe = rng.uniform_u32_to_float(b0)
                u2 = torch.stack([rng.uniform_u32_to_float(b1), rng.uniform_u32_to_float(b2)],
                                 dim=-1)
                s = inner_cls.sample(inner_p, ctx, it, swl, fr.to_world(frame, -w), u_lobe, u2)
                w_up = fr.to_local(frame, s["wi"])
                ok_s = (s["pdf"] > 0) & (fr.cos_theta(w_up) > 0)
                beta = beta * torch.where(
                    ok_s[..., None], s["f"] / torch.clamp(s["pdf"], min=1e-7)[..., None], 0.0)
                beta = beta * absorb(w_up)
                f_int = mf.fresnel_dielectric(fr.cos_theta(w_up), eta, torch.ones_like(eta))
                beta = beta * f_int[..., None]
                alive = alive & ok_s
                w = w_up * flip
            return f_acc

        @staticmethod
        def _coat_weight(wo_l, eta):
            f_o = mf.fresnel_dielectric(fr.abs_cos_theta(wo_l), torch.ones_like(eta), eta)
            return torch.clamp(f_o, 0.05, 0.95)

        @staticmethod
        def evaluate(params, ctx, it, swl, wo, wi):
            inner_p = split(params, "i_")
            e_in = inner_cls.evaluate(inner_p, ctx, it, swl, wo, wi)
            frame = it.shading_frame()
            wo_l = fr.to_local(frame, wo)
            wi_l = fr.to_local(frame, wi)
            same = fr.same_hemisphere(wo_l, wi_l)
            f_c, pdf_c, eta = LayeredMono._coat(params, wo_l, wi_l)
            f_coat = torch.where(same, f_c * fr.abs_cos_theta(wi_l), 0.0)[..., None]
            if LayeredMono.WALK_K > 0:
                f = f_coat + LayeredMono._walk_inner(
                    params, ctx, it, swl, frame, wo_l, wi_l, eta, inner_p)
            else:
                a_inner = inner_cls.albedo(inner_p, ctx, it, swl)
                f = f_coat + e_in["f"] * LayeredMono._transmittances(
                    params, ctx, swl, wo_l, wi_l, eta, a_inner)
            w = LayeredMono._coat_weight(wo_l, eta)
            pdf = torch.where(same, w * pdf_c, 0.0) + (1.0 - w) * e_in["pdf"]
            return {"f": f, "pdf": pdf}

        @staticmethod
        def sample(params, ctx, it, swl, wo, u_lobe, u):
            inner_p = split(params, "i_")
            frame = it.shading_frame()
            wo_l = fr.to_local(frame, wo)
            eta = params["eta"]
            w = LayeredMono._coat_weight(wo_l, eta)
            pick_coat = u_lobe < w
            u_rem = torch.where(pick_coat, u_lobe / torch.clamp(w, min=1e-6),
                                (u_lobe - w) / torch.clamp(1.0 - w, min=1e-6))
            wh = mf.ggx_sample_wh(wo_l, u, resolve_alpha(params))
            wh = torch.where(wo_l[..., 2:3] < 0, -wh, wh)
            wi_coat = fr.to_world(frame, fr.reflect(wo_l, wh))
            s_in = inner_cls.sample(inner_p, ctx, it, swl, wo, u_rem, u)
            wi = torch.where(pick_coat[..., None], wi_coat, s_in["wi"])
            ev = LayeredMono.evaluate(params, ctx, it, swl, wo, wi)
            return {
                "f": ev["f"],
                "pdf": ev["pdf"],
                "wi": wi,
                "event": torch.where(pick_coat, EVENT_REFLECT, s_in["event"]).to(torch.int32),
                "eta": torch.where(pick_coat, torch.ones_like(eta), s_in["eta"]),
            }

        @staticmethod
        def albedo(params, ctx, it, swl):
            return inner_cls.albedo(split(params, "i_"), ctx, it, swl)

        @staticmethod
        def roughness(params, ctx, it):
            return mf.alpha_to_roughness(resolve_alpha(params))

    LayeredMono.__name__ = f"Layered_{inner_cls.__name__}"
    _MONO_CACHE[key] = LayeredMono
    return LayeredMono


@register(SceneNodeTag.SURFACE, "layered", "Layered", "coated", "Coated")
class LayeredSurface(Surface):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        inner = desc.node("base") or desc.node("bottom") or desc.node("inner")
        if inner is None:
            raise ValueError("layered surface requires a 'base' surface")
        self.inner = scene.load_surface(inner)
        self.roughness = scene.load_texture(desc.node("roughness"))
        self.eta = scene.load_texture(desc.node("eta"))
        self.sigma_a = scene.load_texture(desc.node("sigma_a"))
        self.thickness = scene.load_texture(desc.node("thickness"))
        self.remap_roughness = desc.bool("remap_roughness", True)
        # the walk is opt-in; max_depth 10 by default, as in the reference
        self.stochastic = desc.bool("stochastic", False)
        self.max_depth = desc.int("max_depth", 10)

    @property
    def monomorphized(self):
        return monomorphized(device_class(self.inner),
                             self.max_depth if self.stochastic else 0)

    def compile(self, compiler) -> dict:
        row = self.compile_common(compiler)
        for name, default, channels in COAT_PARAMS:
            compile_tex_param(compiler, getattr(self, name), default, row, name, channels)
        row["roughness_channels"] = np.float32(
            self.roughness.channels if self.roughness else 1)
        row["remap_roughness"] = np.float32(1.0 if self.remap_roughness else 0.0)
        row.update({f"i_{k}": v for k, v in self.inner.compile(compiler).items()})
        return row
