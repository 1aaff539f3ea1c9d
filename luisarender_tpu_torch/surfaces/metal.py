"""Metal surface: rough conductor with named spectral eta / k.

Counterpart of luisarender_tpu/surfaces/metal.py. The noble metals and
aluminium evaluate a Lorentz-Drude oscillator model (Rakic et al. 1998) at
the sampled wavelengths; the other named metals store n / k at the three
sRGB peak wavelengths (Johnson & Christy), interpolated between them. The
tables are the reference's, copied: the port imports nothing of it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import microfacet as mf
from ..core.spectrum import SRGB_PEAK_WAVELENGTHS
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..textures.base import compile_tex_params, spectral_param
from .base import Surface
from .mirror import (
    ggx_reflection, reflect_evaluate, reflect_sample, resolve_alpha, roughness_row,
)

# (n_r, n_g, n_b), (k_r, k_g, k_b) at the sRGB peak wavelengths
METAL_IOR = {
    "au": ((0.143, 0.375, 1.442), (3.170, 2.324, 1.796)),
    "ag": ((0.131, 0.125, 0.144), (3.880, 3.340, 2.560)),
    "cu": ((0.300, 0.870, 1.170), (3.220, 2.580, 2.360)),
    "al": ((1.290, 0.960, 0.617), (7.310, 6.390, 5.450)),
    "cr": ((3.190, 3.180, 2.750), (3.330, 3.330, 3.300)),
    "ni": ((1.920, 1.800, 1.650), (3.700, 3.300, 2.820)),
    "ti": ((2.540, 2.480, 2.300), (3.430, 3.350, 3.100)),
    "fe": ((2.900, 2.900, 2.600), (3.100, 3.000, 2.800)),
    "v": ((3.510, 3.660, 3.280), (2.970, 3.000, 3.250)),
    "li": ((0.220, 0.210, 0.230), (2.920, 2.560, 2.110)),
}
METAL_ALIASES = {
    "gold": "au", "silver": "ag", "copper": "cu", "aluminium": "al",
    "aluminum": "al", "chromium": "cr", "chrome": "cr", "nickel": "ni",
    "titanium": "ti", "iron": "fe", "vanadium": "v", "lithium": "li",
}

# Lorentz-Drude parameters: plasma frequency wp [eV], then 6 oscillators
# (f, Gamma [eV], omega [eV]); oscillator 0 is the Drude term (omega = 0),
# unused slots have f = 0
LD_OSC = 6
METAL_LD = {
    "au": {
        "wp": 9.03,
        "f": (0.760, 0.024, 0.010, 0.071, 0.601, 4.384),
        "g": (0.053, 0.241, 0.345, 0.870, 2.494, 2.214),
        "w": (0.000, 0.415, 0.830, 2.969, 4.304, 13.32),
    },
    "ag": {
        "wp": 9.01,
        "f": (0.845, 0.065, 0.124, 0.011, 0.840, 5.646),
        "g": (0.048, 3.886, 0.452, 0.065, 0.916, 2.419),
        "w": (0.000, 0.816, 4.481, 8.185, 9.083, 20.29),
    },
    "cu": {
        "wp": 10.83,
        "f": (0.575, 0.061, 0.104, 0.723, 0.638, 0.000),
        "g": (0.030, 0.378, 1.056, 3.213, 4.305, 1.000),
        "w": (0.000, 0.291, 2.957, 5.300, 11.18, 1.000),
    },
    "al": {
        "wp": 14.98,
        "f": (0.523, 0.227, 0.050, 0.166, 0.030, 0.000),
        "g": (0.047, 0.333, 0.312, 1.351, 3.382, 1.000),
        "w": (0.000, 0.162, 1.544, 1.808, 3.473, 1.000),
    },
}

EV_NM = 1239.84193  # photon energy [eV] * wavelength [nm]


def ld_eta_k(lam_nm, wp, f, g, w):
    """Lorentz-Drude n, k at wavelengths lam_nm (..., C); wp (...,), f / g /
    w (..., LD_OSC), all float32 tensors."""
    omega = EV_NM / torch.clamp(lam_nm, min=1e-3)
    wp2 = (wp**2)[..., None, None]
    o = omega[..., None, :]
    a = (w**2)[..., :, None] - o * o
    b = o * g[..., :, None]
    d = torch.clamp(a * a + b * b, min=1e-12)
    fj = f[..., :, None]
    # summed oscillator by oscillator, in order, as the reference rounds it
    re = (fj * wp2 * a / d).unbind(-2)
    im = (fj * wp2 * b / d).unbind(-2)
    sum_re, sum_im = re[0], im[0]
    for j in range(1, len(re)):
        sum_re = sum_re + re[j]
        sum_im = sum_im + im[j]
    eps_re = 1.0 + sum_re
    eps_im = sum_im
    mag = torch.sqrt(eps_re * eps_re + eps_im * eps_im)
    n = torch.sqrt(torch.clamp(0.5 * (mag + eps_re), min=0.0))
    k = torch.sqrt(torch.clamp(0.5 * (mag - eps_re), min=0.0))
    return n, k


def metal_eta_k(name: str):
    key = METAL_ALIASES.get(name.lower(), name.lower())
    if key not in METAL_IOR:
        raise KeyError(
            f"unknown metal '{name}'; available: "
            f"{sorted(list(METAL_IOR) + list(METAL_ALIASES))}"
        )
    n, k = METAL_IOR[key]
    return np.asarray(n, np.float32), np.asarray(k, np.float32)


def _interp3(lam, xs, ys):
    """Piecewise-linear through 3 ascending knots xs; ys (..., 3)."""
    lam_c = torch.clamp(lam, xs[0], xs[2])
    t_lo = (lam_c - xs[0]) / (xs[1] - xs[0])
    t_hi = (lam_c - xs[1]) / (xs[2] - xs[1])
    v_lo = ys[..., 0:1] * (1.0 - t_lo) + ys[..., 1:2] * t_lo
    v_hi = ys[..., 1:2] * (1.0 - t_hi) + ys[..., 2:3] * t_hi
    return torch.where(lam_c <= xs[1], v_lo, v_hi)


def eta_k_at_wavelengths(n3, k3, lam):
    """The 3-sample n / k curves (stored R, G, B = descending nm) at the
    wavelengths lam (..., C)."""
    xs = tuple(SRGB_PEAK_WAVELENGTHS[::-1])
    return _interp3(lam, xs, n3.flip(-1)), _interp3(lam, xs, k3.flip(-1))


@register(SceneNodeTag.SURFACE, "metal", "Metal")
class MetalSurface(Surface):
    texture_params = (("roughness", (0.0,) * 4, 2), ("kd", (1.0, 1.0, 1.0, 0.0), 3))
    spectral_params = (("kd", "albedo"),)

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.roughness = scene.load_texture(desc.node("roughness"))
        self.remap_roughness = desc.bool("remap_roughness", True)
        self.kd = scene.load_texture(desc.node("Kd"))
        eta_name = desc.string("eta", None) or desc.string("material", None)
        self.ld = None
        if eta_name is not None:
            self.n3, self.k3 = metal_eta_k(eta_name)
            self.ld = METAL_LD.get(METAL_ALIASES.get(eta_name.lower(), eta_name.lower()))
        else:
            self.n3 = np.asarray(desc.float3("n", (0.2, 0.92, 1.1)), np.float32)
            self.k3 = np.asarray(desc.float3("k", (3.9, 2.45, 2.14)), np.float32)

    def compile(self, compiler) -> dict:
        ld = self.ld
        return {
            **self.compile_common(compiler),
            **compile_tex_params(self, compiler),
            **roughness_row(self),
            "eta_n": self.n3,
            "eta_k": self.k3,
            "ld_valid": np.float32(0.0 if ld is None else 1.0),
            "ld_wp": np.float32(ld["wp"] if ld else 1.0),
            "ld_f": np.asarray(ld["f"] if ld else (0.0,) * LD_OSC, np.float32),
            "ld_g": np.asarray(ld["g"] if ld else (1.0,) * LD_OSC, np.float32),
            "ld_w": np.asarray(ld["w"] if ld else (1.0,) * LD_OSC, np.float32),
        }

    @staticmethod
    def _fresnel(params, swl, cos_i):
        n, k = eta_k_at_wavelengths(params["eta_n"], params["eta_k"], swl.lam)
        n_ld, k_ld = ld_eta_k(
            swl.lam, params["ld_wp"], params["ld_f"], params["ld_g"], params["ld_w"]
        )
        use_ld = (params["ld_valid"] > 0.5)[..., None]
        return mf.fresnel_conductor(
            cos_i, torch.where(use_ld, n_ld, n), torch.where(use_ld, k_ld, k)
        )

    @staticmethod
    def _eval_local(params, ctx, swl, wo_l, wi_l):
        tint = spectral_param(ctx, params, "kd", swl, "albedo")
        return ggx_reflection(
            wo_l, wi_l, resolve_alpha(params),
            lambda c: tint * MetalSurface._fresnel(params, swl, c),
        )

    @staticmethod
    def evaluate(params, ctx, it, swl, wo, wi):
        return reflect_evaluate(
            params, ctx, it, wo, wi,
            lambda a, b: MetalSurface._eval_local(params, ctx, swl, a, b),
        )

    @staticmethod
    def sample(params, ctx, it, swl, wo, u_lobe, u):
        return reflect_sample(
            params, ctx, it, wo, u,
            lambda a, b: MetalSurface._eval_local(params, ctx, swl, a, b),
        )

    @staticmethod
    def albedo(params, ctx, it, swl):
        return MetalSurface._fresnel(params, swl, torch.ones(it.p.shape[:-1], device=it.p.device))

    @staticmethod
    def roughness(params, ctx, it):
        return mf.alpha_to_roughness(resolve_alpha(params))
