"""Microfacet distributions and Fresnel terms.

Counterpart of luisarender_tpu/core/microfacet.py: anisotropic
Trowbridge-Reitz (GGX) with Smith masking and visible-normal sampling
(Heitz 2018), dielectric / conductor / Schlick Fresnel, and the roughness
remap alpha = roughness^2 clamped at 1e-4. Batched over leading dims, in the
local shading frame (z up); alpha is (..., 2).
"""

from __future__ import annotations

import math

import torch

from . import frame as fr

PI = math.pi


def roughness_to_alpha(roughness):
    return torch.clamp(roughness * roughness, min=1e-4)


def alpha_to_roughness(alpha):
    return torch.sqrt(torch.clamp(alpha, min=1e-4))


def ggx_d(wh, alpha):
    """Normal distribution function D(wh)."""
    ax, ay = alpha[..., 0], alpha[..., 1]
    cos2 = fr.cos2_theta(wh)
    cos4 = cos2 * cos2
    tan2 = fr.sin2_theta(wh) / torch.clamp(cos2, min=1e-12)
    e = tan2 * ((fr.cos_phi(wh) / ax) ** 2 + (fr.sin_phi(wh) / ay) ** 2)
    d = 1.0 / (PI * ax * ay * torch.clamp(cos4, min=1e-12) * (1.0 + e) ** 2)
    return torch.where(cos2 > 1e-12, d, 0.0)


def ggx_lambda(w, alpha):
    ax, ay = alpha[..., 0], alpha[..., 1]
    cos2 = fr.cos2_theta(w)
    tan2 = fr.sin2_theta(w) / torch.clamp(cos2, min=1e-12)
    a2 = fr.cos_phi(w) ** 2 * ax * ax + fr.sin_phi(w) ** 2 * ay * ay
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + a2 * tan2))
    return torch.where(cos2 > 1e-12, lam, 0.0)


def ggx_g1(w, alpha):
    return 1.0 / (1.0 + ggx_lambda(w, alpha))


def ggx_g(wo, wi, alpha):
    return 1.0 / (1.0 + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha))


def ggx_sample_wh(wo, u, alpha):
    """Visible-normal sample (sphere-cap method); wo in either hemisphere,
    wh returned in the upper one."""
    flip = wo[..., 2] < 0.0
    wo_u = torch.where(flip[..., None], -wo, wo)
    ax, ay = alpha[..., 0], alpha[..., 1]
    vh = fr.normalize(torch.stack([ax * wo_u[..., 0], ay * wo_u[..., 1], wo_u[..., 2]], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], dim=-1)
        / torch.sqrt(torch.clamp(lensq, min=1e-12))[..., None],
        torch.tensor([1.0, 0.0, 0.0], device=wo.device).expand(vh.shape),
    )
    t2 = fr.cross(vh, t1)
    r = torch.sqrt(torch.clamp(u[..., 0], min=0.0))
    phi = 2.0 * PI * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))[..., None] * vh
    )
    return fr.normalize(
        torch.stack([ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)], dim=-1)
    )


def ggx_pdf(wo, wh, alpha):
    """pdf of ggx_sample_wh over wh solid angle."""
    wo_u = torch.where((wo[..., 2] < 0.0)[..., None], -wo, wo)
    return (
        ggx_d(wh, alpha)
        * ggx_g1(wo_u, alpha)
        * torch.clamp(fr.dot(wo_u, wh), min=0.0)
        / torch.clamp(fr.abs_cos_theta(wo_u), min=1e-8)
    )


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel; cos_i signed, indices swap for
    back-side incidence."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    sin_i = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-8)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-8)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, f)


def fresnel_conductor(cos_i, eta, k):
    """Conductor Fresnel; eta / k (..., C), cos_i (...,)."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - si2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * k2, min=0.0))
    t1 = a2b2 + ci2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-8)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-8)
    return 0.5 * (rp + rs)


def fresnel_schlick(cos_i, f0):
    """Schlick's approximation; f0 (..., C)."""
    m = torch.clamp(1.0 - torch.abs(cos_i), 0.0, 1.0)
    w = (m * m) * (m * m) * m
    return f0 + (1.0 - f0) * w[..., None]


def fresnel_dielectric_integral(eta):
    """The hemispherical average of the dielectric Fresnel reflectance
    (Egan and Hilgeman's rational fits), as the reference takes it."""
    inv = 1.0 / eta
    f_lt1 = -0.4399 + 0.7099 * inv - 0.3319 * inv * inv + 0.0636 * inv * inv * inv
    e2 = eta * eta
    f_ge1 = -1.4399 / e2 + 0.7099 / eta + 0.6681 + 0.0636 * eta
    return torch.where(eta < 1.0, f_lt1, f_ge1)
