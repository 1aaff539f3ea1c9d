"""Glass surface: rough dielectric reflection and transmission.

Counterpart of luisarender_tpu/surfaces/glass.py: GGX reflection and
transmission, a Fresnel-weighted lobe pick scaled by the Kr / Kt luminance
ratio, enter / exit events, and named glasses whose index comes from the
Sellmeier equations fitted to a two-term Cauchy model A + B / lambda^2 at
the Fraunhofer C / d / F lines. Only the fixed sRGB spectrum is ported, so
the index is taken at the first sRGB peak wavelength.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import frame as fr
from ..core import microfacet as mf
from ..core.colorspace import cie_y_of_srgb
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..textures.base import compile_tex_params, spectral_param
from .base import EVENT_ENTER, EVENT_EXIT, EVENT_REFLECT, Surface, oriented_frame
from .mirror import resolve_alpha, roughness_row

FRAUNHOFER_C = 656.27
FRAUNHOFER_D = 587.56
FRAUNHOFER_F = 486.13

# Sellmeier coefficients (B1 B2 B3 C1 C2 C3, lambda in micrometres)
_SELLMEIER = {
    "bk7": (1.03961212, 0.231792344, 1.01046945,
            0.00600069867, 0.0200179144, 103.560653),
    "baf10": (1.5851495, 0.143559385, 1.08521269,
              0.00926681282, 0.0424489805, 105.613573),
    "fk51a": (0.971247817, 0.216901417, 0.904651666,
              0.00472301995, 0.0153575612, 168.68133),
    "lasf9": (2.00029547, 0.298926886, 1.80691843,
              0.0121426017, 0.0538736236, 156.530829),
    "sf5": (1.52481889, 0.187085527, 1.42729015,
            0.011254756, 0.0588995392, 129.141675),
    "sf10": (1.62153902, 0.256287842, 1.64447552,
             0.0122241457, 0.0595736775, 147.468793),
    "sf11": (1.73759695, 0.313747346, 1.89878101,
             0.013188707, 0.0623068142, 155.23629),
    "f2": (1.34533359, 0.209073176, 0.937357162,
           0.00997743871, 0.0470450767, 111.886764),
    "fused_silica": (0.6961663, 0.4079426, 0.8974794,
                     0.0684043**2, 0.1162414**2, 9.896161**2),
    "sapphire": (1.4313493, 0.65054713, 5.3414021,
                 0.0726631**2, 0.1193242**2, 18.028251**2),
}
_FIXED_IOR = {"water": 1.333, "ice": 1.31, "air": 1.0003, "vacuum": 1.0}
_DIAMOND = (0.3306, 4.3356, 0.0, 0.175**2, 0.106**2, 1.0)


def glass_ior(name: str, lam_nm: float) -> float:
    """n(lambda) of a named glass; lambda in nm."""
    key = name.lower()
    l2 = (lam_nm * 1e-3) ** 2
    if key in _FIXED_IOR:
        return _FIXED_IOR[key]
    if key == "diamond":
        b1, b2, _, c1, c2, _ = _DIAMOND
        return float(np.sqrt(1.0 + b1 * l2 / (l2 - c1) + b2 * l2 / (l2 - c2)))
    if key in _SELLMEIER:
        b1, b2, b3, c1, c2, c3 = _SELLMEIER[key]
        n2 = 1.0 + b1 * l2 / (l2 - c1) + b2 * l2 / (l2 - c2) + b3 * l2 / (l2 - c3)
        return float(np.sqrt(max(n2, 1.0)))
    raise KeyError(
        f"unknown glass '{name}'; available: "
        f"{sorted(list(_SELLMEIER) + list(_FIXED_IOR) + ['diamond'])}"
    )


def fit_cauchy(n_c: float, n_d: float, n_f: float):
    """Least-squares n(lambda) ~ A + B / lambda^2 (um) through C / d / F."""
    lams = np.asarray([FRAUNHOFER_C, FRAUNHOFER_D, FRAUNHOFER_F]) * 1e-3
    a = np.stack([np.ones(3), 1.0 / lams**2], axis=-1)
    coef, *_ = np.linalg.lstsq(a, np.asarray([n_c, n_d, n_f]), rcond=None)
    return float(coef[0]), float(coef[1])


def _named_cauchy(name):
    return fit_cauchy(*(glass_ior(name, lam) for lam in (FRAUNHOFER_C, FRAUNHOFER_D, FRAUNHOFER_F)))


def cauchy_eta(cauchy_a, cauchy_b, lam_nm):
    return cauchy_a + cauchy_b / (lam_nm * 1e-3) ** 2


@register(SceneNodeTag.SURFACE, "glass", "Glass")
class GlassSurface(Surface):
    texture_params = (
        ("kr", (1.0, 1.0, 1.0, 0.0), 3),
        ("kt", (1.0, 1.0, 1.0, 0.0), 3),
        ("roughness", (0.0,) * 4, 2),
    )
    spectral_params = (("kr", "albedo"), ("kt", "albedo"))

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.kr = scene.load_texture(desc.node("Kr"))
        self.kt = scene.load_texture(desc.node("Kt"))
        self.roughness = scene.load_texture(desc.node("roughness"))
        self.remap_roughness = desc.bool("remap_roughness", True)
        material = desc.string("material", None)
        eta_node = desc.node("eta")
        if material is not None:
            self.cauchy = _named_cauchy(material)
        elif eta_node is not None:
            tex = scene.load_texture(eta_node)
            v = tex.evaluate_static()
            if v is None:
                # a texture that varies is loaded and never compiled or
                # read: the index is Cauchy (1.5, 0), as in the reference
                self.cauchy = (1.5, 0.0)
            elif tex.channels >= 3:  # values at the Fraunhofer lines
                self.cauchy = fit_cauchy(float(v[0]), float(v[1]), float(v[2]))
            else:
                self.cauchy = (float(v[0]), 0.0)
        else:
            self.cauchy = _named_cauchy("bk7")

    def compile(self, compiler) -> dict:
        return {
            **self.compile_common(compiler),
            **compile_tex_params(self, compiler),
            **roughness_row(self),
            "cauchy_a": np.float32(self.cauchy[0]),
            "cauchy_b": np.float32(self.cauchy[1]),
        }

    @staticmethod
    def _eta_t(params, swl):
        """The index at the first (hero) sampled wavelength."""
        return cauchy_eta(params["cauchy_a"], params["cauchy_b"], swl.lam[..., 0])

    @staticmethod
    def eta_value(params, ctx, it, swl):
        return GlassSurface._eta_t(params, swl)

    @staticmethod
    def is_dispersive_rows(params, ctx):
        return torch.abs(params["cauchy_b"]) > 1e-9

    @staticmethod
    def kr_ratio(params):
        kr_lum = cie_y_of_srgb(params["kr"])
        kt_lum = cie_y_of_srgb(params["kt"])
        return torch.where(kr_lum <= 0.0, 0.0, kr_lum / torch.clamp(kr_lum + kt_lum, min=1e-8))

    @staticmethod
    def refl_prob(kr_ratio, f_wo):
        r = kr_ratio * f_wo
        t = (1.0 - kr_ratio) * (1.0 - f_wo)
        return torch.where(r <= 0.0, 0.0, r / torch.clamp(r + t, min=1e-8))

    @staticmethod
    def _eval_local(params, ctx, swl, wo_l, wi_l):
        """(f, pdf) with |cos_i| folded into f."""
        kr_s = spectral_param(ctx, params, "kr", swl, "albedo")
        kt_s = spectral_param(ctx, params, "kt", swl, "albedo")
        alpha = resolve_alpha(params)
        eta_t = GlassSurface._eta_t(params, swl)
        one = torch.ones_like(eta_t)
        cos_o = fr.cos_theta(wo_l)
        cos_i = fr.cos_theta(wi_l)
        same = fr.same_hemisphere(wo_l, wi_l)
        f_wo = mf.fresnel_dielectric(cos_o, one, eta_t)
        ratio = GlassSurface.refl_prob(GlassSurface.kr_ratio(params), f_wo)

        # reflection lobe
        wh_r = fr.normalize(wo_l + wi_l)
        wh_r = torch.where(fr.cos_theta(wh_r)[..., None] < 0.0, -wh_r, wh_r)
        d_r = mf.ggx_d(wh_r, alpha)
        g_r = mf.ggx_g(wo_l, wi_l, alpha)
        f_h = mf.fresnel_dielectric(fr.dot(wo_l, wh_r), one, eta_t)
        f_refl = kr_s * (f_h * d_r * g_r / torch.clamp(4.0 * torch.abs(cos_o), min=1e-8))[..., None]
        pdf_refl = (
            mf.ggx_pdf(wo_l, wh_r, alpha)
            / torch.clamp(4.0 * torch.abs(fr.dot(wo_l, wh_r)), min=1e-8)
            * ratio
        )

        # transmission lobe (radiance transport)
        eta_rel = torch.where(cos_o > 0.0, eta_t, 1.0 / eta_t)
        wh_t = fr.normalize(wo_l + wi_l * eta_rel[..., None])
        wh_t = torch.where(fr.cos_theta(wh_t)[..., None] < 0.0, -wh_t, wh_t)
        dot_o = fr.dot(wo_l, wh_t)
        dot_i = fr.dot(wi_l, wh_t)
        trans_ok = (~same) & (dot_o * dot_i < 0.0) & (torch.abs(cos_o) > 1e-6) & (
            torch.abs(cos_i) > 1e-6
        )
        g_t = mf.ggx_g(wo_l, wi_l, alpha)
        d_t = mf.ggx_d(wh_t, alpha)
        f_ht = mf.fresnel_dielectric(dot_o, one, eta_t)
        denom = dot_o + eta_rel * dot_i
        f_trans_scalar = (
            (1.0 - f_ht) * d_t * g_t * torch.abs(dot_i * dot_o)
            / torch.clamp(torch.abs(cos_i * cos_o) * denom * denom, min=1e-10)
        )
        f_trans = kt_s * f_trans_scalar[..., None]
        dwh_dwi = (eta_rel / torch.clamp(torch.abs(denom), min=1e-8)) ** 2 * torch.abs(dot_i)
        pdf_trans = mf.ggx_pdf(wo_l, wh_t, alpha) * dwh_dwi * (1.0 - ratio)

        abs_ci = torch.abs(cos_i)[..., None]
        f = torch.where(
            same[..., None], f_refl * abs_ci,
            torch.where(trans_ok[..., None], f_trans * abs_ci, 0.0),
        )
        pdf = torch.where(same, pdf_refl, torch.where(trans_ok, pdf_trans, 0.0))
        return f, pdf

    @staticmethod
    def evaluate(params, ctx, it, swl, wo, wi):
        frame = oriented_frame(params, ctx, it, wo)
        f, pdf = GlassSurface._eval_local(
            params, ctx, swl, fr.to_local(frame, wo), fr.to_local(frame, wi)
        )
        return {"f": f, "pdf": pdf}

    @staticmethod
    def sample(params, ctx, it, swl, wo, u_lobe, u):
        frame = oriented_frame(params, ctx, it, wo)
        wo_l = fr.to_local(frame, wo)
        alpha = resolve_alpha(params)
        eta_t = GlassSurface._eta_t(params, swl)
        f_wo = mf.fresnel_dielectric(fr.cos_theta(wo_l), torch.ones_like(eta_t), eta_t)
        pick_refl = u_lobe < GlassSurface.refl_prob(GlassSurface.kr_ratio(params), f_wo)

        above = fr.cos_theta(wo_l) > 0.0
        wh = mf.ggx_sample_wh(wo_l, u, alpha)
        wh = torch.where((fr.cos_theta(wo_l) < 0.0)[..., None], -wh, wh)
        wi_refl = fr.reflect(wo_l, wh)
        eta_rel_in = torch.where(above, 1.0 / eta_t, eta_t)
        ok_t, wi_trans = fr.refract(
            wo_l, torch.where(fr.dot(wo_l, wh)[..., None] < 0, -wh, wh), eta_rel_in
        )
        wi_l = torch.where(pick_refl[..., None], wi_refl, wi_trans)
        f, pdf = GlassSurface._eval_local(params, ctx, swl, wo_l, wi_l)
        pdf = torch.where(pick_refl | ok_t, pdf, 0.0)
        event = torch.where(
            pick_refl, EVENT_REFLECT, torch.where(above, EVENT_ENTER, EVENT_EXIT)
        ).to(torch.int32)
        return {"f": f, "pdf": pdf, "wi": fr.to_world(frame, wi_l), "event": event,
                "eta": eta_t}

    @staticmethod
    def albedo(params, ctx, it, swl):
        return spectral_param(ctx, params, "kr", swl, "albedo")

    @staticmethod
    def roughness(params, ctx, it):
        return mf.alpha_to_roughness(resolve_alpha(params))
