"""Component-wise BSDF closures of the fused whole-path kernel, plain
PyTorch.

Counterpart of luisarender_tpu/ops/fused_bsdf.py, and the plain version of
the device functions of csrc/fused_path.cu: every vector is a tuple of
per-lane (N,) tensors and every material parameter a per-lane tensor read
from the instance row (`ic`, see ops/fused_path.py INST_COLS). The
operation order is the reference's, term by term, so that the CUDA kernel
(built with --fmad=false) rounds the same way except in the transcendentals.
"""

from __future__ import annotations

import math

import torch

PI = math.pi
INV_PI = 1.0 / PI

# surface-type tags (inst_table column 0)
ST_MATTE = 0
ST_MIRROR = 1
ST_METAL = 2
ST_PLASTIC = 3
ST_GLASS = 4
ST_DISNEY = 6

EVENT_REFLECT = 0
EVENT_ENTER = 1
EVENT_EXIT = 2


where = torch.where


def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def normalize3(x, y, z, eps=1e-20):
    inv = 1.0 / torch.clamp(torch.sqrt(x * x + y * y + z * z), min=eps)
    return x * inv, y * inv, z * inv


def concentric_disk(u0, u1):
    ux = 2.0 * u0 - 1.0
    uy = 2.0 * u1 - 1.0
    zero = (ux == 0.0) & (uy == 0.0)
    use_x = torch.abs(ux) > torch.abs(uy)
    r = where(use_x, ux, uy)
    theta = where(
        use_x,
        (PI / 4.0) * (uy / where(ux == 0.0, 1.0, ux)),
        (PI / 2.0) - (PI / 4.0) * (ux / where(uy == 0.0, 1.0, uy)),
    )
    return where(zero, 0.0, r * torch.cos(theta)), where(zero, 0.0, r * torch.sin(theta))


# --- GGX ---------------------------------------------------------------


def ggx_d(hx, hy, hz, ax, ay):
    cos2 = hz * hz
    cos4 = cos2 * cos2
    e = (hx * hx / (ax * ax) + hy * hy / (ay * ay)) / torch.clamp(cos2, min=1e-12)
    e1 = 1.0 + e
    d = 1.0 / (PI * ax * ay * torch.clamp(cos4, min=1e-12) * (e1 * e1))
    return where(cos2 > 1e-12, d, 0.0)


def ggx_lambda(wx, wy, wz, ax, ay):
    cos2 = wz * wz
    a2tan2 = (wx * wx * ax * ax + wy * wy * ay * ay) / torch.clamp(cos2, min=1e-12)
    lam = 0.5 * (-1.0 + torch.sqrt(torch.clamp(1.0 + a2tan2, min=0.0)))
    return where(cos2 > 1e-12, lam, 0.0)


def ggx_g(wox, woy, woz, wix, wiy, wiz, ax, ay):
    return 1.0 / (1.0 + ggx_lambda(wox, woy, woz, ax, ay) + ggx_lambda(wix, wiy, wiz, ax, ay))


def ggx_g1(wx, wy, wz, ax, ay):
    return 1.0 / (1.0 + ggx_lambda(wx, wy, wz, ax, ay))


def ggx_sample_wh(wox, woy, woz, u0, u1, ax, ay):
    flip = woz < 0.0
    ux = where(flip, -wox, wox)
    uy = where(flip, -woy, woy)
    uz = where(flip, -woz, woz)
    vx, vy, vz = normalize3(ax * ux, ay * uy, uz)
    lensq = vx * vx + vy * vy
    ok = lensq > 1e-12
    inv_l = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    t1x = where(ok, -vy * inv_l, 1.0)
    t1y = where(ok, vx * inv_l, 0.0)
    t1z = torch.zeros_like(vx)
    t2x = vy * t1z - vz * t1y
    t2y = vz * t1x - vx * t1z
    t2z = vx * t1y - vy * t1x
    r = torch.sqrt(torch.clamp(u0, min=0.0))
    phi = 2.0 * PI * u1
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    sc = 0.5 * (1.0 + vz)
    p2 = (1.0 - sc) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + sc * p2
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nhx = p1 * t1x + p2 * t2x + pz * vx
    nhy = p1 * t1y + p2 * t2y + pz * vy
    nhz = p1 * t1z + p2 * t2z + pz * vz
    return normalize3(ax * nhx, ay * nhy, torch.clamp(nhz, min=1e-6))


def ggx_pdf(wox, woy, woz, hx, hy, hz, ax, ay):
    flip = woz < 0.0
    ux = where(flip, -wox, wox)
    uy = where(flip, -woy, woy)
    uz = where(flip, -woz, woz)
    return (
        ggx_d(hx, hy, hz, ax, ay)
        * ggx_g1(ux, uy, uz, ax, ay)
        * torch.clamp(ux * hx + uy * hy + uz * hz, min=0.0)
        / torch.clamp(torch.abs(uz), min=1e-8)
    )


# --- Fresnel -----------------------------------------------------------


def fres_dielectric(cos_i, eta_t):
    """Unpolarized dielectric Fresnel with eta_i = 1."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = where(entering, 1.0, eta_t)
    et = where(entering, eta_t, 1.0)
    ci = torch.abs(cos_i)
    sin_i = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-8)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-8)
    return where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp))


def fres_conductor_1(cos_i, eta, k):
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
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


def schlick_w(cos_t):
    m = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    return (m * m) * (m * m) * m


def fres_schlick_1(cos_i, f0):
    return f0 + (1.0 - f0) * schlick_w(torch.abs(cos_i))


# --- per-type (f_r, f_g, f_b, pdf) at a local wi, without side validation


def eval_matte(ic, wo, wi):
    wol_x, wol_y, wol_z = wo
    wil_x, wil_y, wil_z = wi
    cos_o = torch.abs(wol_z)
    cos_i = torch.abs(wil_z)
    sin_o = torch.sqrt(torch.clamp(1.0 - wol_z * wol_z, min=0.0))
    sin_i = torch.sqrt(torch.clamp(1.0 - wil_z * wil_z, min=0.0))
    inv_so = 1.0 / torch.clamp(sin_o, min=1e-20)
    inv_si = 1.0 / torch.clamp(sin_i, min=1e-20)
    cos_d_phi = (wil_x * inv_si) * (wol_x * inv_so) + (wil_y * inv_si) * (wol_y * inv_so)
    max_cos = where((sin_i > 1e-4) & (sin_o > 1e-4), torch.clamp(cos_d_phi, min=0.0), 0.0)
    o_gt_i = cos_o > cos_i
    sin_alpha = where(o_gt_i, sin_i, sin_o)
    tan_beta = where(
        o_gt_i, sin_o / torch.clamp(cos_o, min=1e-6), sin_i / torch.clamp(cos_i, min=1e-6)
    )
    on = ic["p0"] + ic["p1"] * max_cos * sin_alpha * tan_beta
    same = wol_z * wil_z > 0.0
    scale = where(same, INV_PI * on * cos_i, 0.0)
    pdf = where(same, cos_i * INV_PI, 0.0)
    return ic["c0r"] * scale, ic["c0g"] * scale, ic["c0b"] * scale, pdf


def eval_mirror_metal(ic, wo, wi, metal):
    """GGX reflection: Schlick with F0 = c0 (mirror), or conductor Fresnel
    with n = c2, k = c3 tinted by c0 (metal)."""
    wol_x, wol_y, wol_z = wo
    wil_x, wil_y, wil_z = wi
    ax, ay = ic["ax"], ic["ay"]
    hx, hy, hz = normalize3(wol_x + wil_x, wol_y + wil_y, wol_z + wil_z)
    same = wol_z * wil_z > 0.0
    cos_o = torch.abs(wol_z)
    cos_i = torch.abs(wil_z)
    d = ggx_d(hx, hy, hz, ax, ay)
    g = ggx_g(wol_x, wol_y, wol_z, wil_x, wil_y, wil_z, ax, ay)
    dot_ih = wil_x * hx + wil_y * hy + wil_z * hz
    scale = d * g / torch.clamp(4.0 * cos_o, min=1e-8)
    if metal:
        f = [ic["c0" + c] * fres_conductor_1(dot_ih, ic["c2" + c], ic["c3" + c]) for c in "rgb"]
    else:
        f = [fres_schlick_1(dot_ih, ic["c0" + c]) for c in "rgb"]
    dot_oh = wol_x * hx + wol_y * hy + wol_z * hz
    pdf = ggx_pdf(wol_x, wol_y, wol_z, hx, hy, hz, ax, ay) / torch.clamp(
        4.0 * torch.abs(dot_oh), min=1e-8
    )
    valid = same & (cos_o > 1e-6) & (cos_i > 1e-6)
    zed = where(valid, scale, 0.0)
    return f[0] * zed, f[1] * zed, f[2] * zed, where(valid, pdf, 0.0)


def plastic_substrate_weight(ic, f_o):
    w = ic["p1"] * (1.0 - f_o)
    return where(w <= 0.0, 0.0, w / torch.clamp(w + f_o, min=1e-8))


def eval_plastic(ic, wo, wi):
    neg = wo[2] < 0.0
    wol_x, wol_y, wol_z = wo[0], wo[1], where(neg, -wo[2], wo[2])
    wil_x, wil_y, wil_z = wi[0], wi[1], where(neg, -wi[2], wi[2])
    eta = ic["p0"]
    ax, ay = ic["ax"], ic["ay"]
    cos_o = torch.abs(wol_z)
    cos_i = torch.abs(wil_z)
    same = wol_z * wil_z > 0.0
    hx, hy, hz = normalize3(wol_x + wil_x, wol_y + wil_y, wol_z + wil_z)
    d = ggx_d(hx, hy, hz, ax, ay)
    g = ggx_g(wol_x, wol_y, wol_z, wil_x, wil_y, wil_z, ax, ay)
    f_h = fres_dielectric(wil_x * hx + wil_y * hy + wil_z * hz, eta)
    f_coat = f_h * d * g / torch.clamp(4.0 * cos_o * cos_i, min=1e-8)
    dot_oh = wol_x * hx + wol_y * hy + wol_z * hz
    pdf_coat = ggx_pdf(wol_x, wol_y, wol_z, hx, hy, hz, ax, ay) / torch.clamp(
        4.0 * torch.abs(dot_oh), min=1e-8
    )
    f_i = fres_dielectric(cos_i, eta)
    f_o = fres_dielectric(cos_o, eta)
    a_exp = -(1.0 / torch.clamp(cos_i, min=1e-6) + 1.0 / torch.clamp(cos_o, min=1e-6))
    diff_base = (1.0 - f_i) * (1.0 - f_o) / torch.clamp(eta * eta, min=1e-8) * INV_PI
    w = plastic_substrate_weight(ic, f_o)
    pdf = (1.0 - w) * pdf_coat + w * (cos_i * INV_PI)
    f = [
        where(same, (f_coat + diff_base * torch.exp(a_exp * ic["c1" + c]) * ic["c0" + c]) * cos_i, 0.0)
        for c in "rgb"
    ]
    return f[0], f[1], f[2], where(same, pdf, 0.0)


def glass_refl_prob(ic, f_wo):
    r = ic["p1"] * f_wo
    t = (1.0 - ic["p1"]) * (1.0 - f_wo)
    return where(r <= 0.0, 0.0, r / torch.clamp(r + t, min=1e-8))


def eval_glass(ic, wo, wi):
    """|cos_i| folded into f; the pdf includes the lobe-pick ratio."""
    wol_x, wol_y, wol_z = wo
    wil_x, wil_y, wil_z = wi
    eta_t = ic["p0"]
    ax, ay = ic["ax"], ic["ay"]
    cos_o = wol_z
    cos_i = wil_z
    same = cos_o * cos_i > 0.0
    ratio = glass_refl_prob(ic, fres_dielectric(cos_o, eta_t))

    hx, hy, hz = normalize3(wol_x + wil_x, wol_y + wil_y, wol_z + wil_z)
    neg = hz < 0.0
    hx, hy, hz = where(neg, -hx, hx), where(neg, -hy, hy), where(neg, -hz, hz)
    d_r = ggx_d(hx, hy, hz, ax, ay)
    g_r = ggx_g(wol_x, wol_y, wol_z, wil_x, wil_y, wil_z, ax, ay)
    dot_oh = wol_x * hx + wol_y * hy + wol_z * hz
    f_h = fres_dielectric(dot_oh, eta_t)
    refl_scale = f_h * d_r * g_r / torch.clamp(4.0 * torch.abs(cos_o), min=1e-8)
    pdf_refl = ggx_pdf(wol_x, wol_y, wol_z, hx, hy, hz, ax, ay) / torch.clamp(
        4.0 * torch.abs(dot_oh), min=1e-8
    ) * ratio

    eta_rel = where(cos_o > 0.0, eta_t, 1.0 / eta_t)
    tx, ty, tz = normalize3(
        wol_x + wil_x * eta_rel, wol_y + wil_y * eta_rel, wol_z + wil_z * eta_rel
    )
    negt = tz < 0.0
    tx, ty, tz = where(negt, -tx, tx), where(negt, -ty, ty), where(negt, -tz, tz)
    dot_o = wol_x * tx + wol_y * ty + wol_z * tz
    dot_i = wil_x * tx + wil_y * ty + wil_z * tz
    trans_ok = (~same) & (dot_o * dot_i < 0.0) & (torch.abs(cos_o) > 1e-6) & (
        torch.abs(cos_i) > 1e-6
    )
    g_t = ggx_g(wol_x, wol_y, wol_z, wil_x, wil_y, wil_z, ax, ay)
    d_t = ggx_d(tx, ty, tz, ax, ay)
    f_ht = fres_dielectric(dot_o, eta_t)
    denom = dot_o + eta_rel * dot_i
    trans_scale = (
        (1.0 - f_ht) * d_t * g_t * torch.abs(dot_i * dot_o)
        / torch.clamp(torch.abs(cos_i * cos_o) * denom * denom, min=1e-10)
    )
    q = eta_rel / torch.clamp(torch.abs(denom), min=1e-8)
    dwh_dwi = (q * q) * torch.abs(dot_i)
    pdf_trans = ggx_pdf(wol_x, wol_y, wol_z, tx, ty, tz, ax, ay) * dwh_dwi * (1.0 - ratio)

    abs_ci = torch.abs(cos_i)
    refl_f = refl_scale * abs_ci
    trans_f = trans_scale * abs_ci
    f = [
        where(same, ic["c0" + c] * refl_f, where(trans_ok, ic["c1" + c] * trans_f, 0.0))
        for c in "rgb"
    ]
    pdf = where(same, pdf_refl, where(trans_ok, pdf_trans, 0.0))
    return f[0], f[1], f[2], pdf


def refract_c(wix, wiy, wiz, nx, ny, nz, eta):
    """Refraction with eta = eta_i / eta_t: (valid, wt)."""
    cos_i = nx * wix + ny * wiy + nz * wiz
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    coef = eta * cos_i - cos_t
    return sin2_t < 1.0, (eta * -wix + coef * nx, eta * -wiy + coef * ny, eta * -wiz + coef * nz)


def gtr1(cos_h, alpha):
    a2 = alpha * alpha
    denom = PI * torch.log(torch.clamp(a2, min=1e-8)) * (1.0 + (a2 - 1.0) * cos_h * cos_h)
    return (a2 - 1.0) / where(torch.abs(denom) < 1e-12, 1e-12, denom)


def _smith_g_sep_z(wz, alpha):
    c2 = wz * wz
    t2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-9)
    return 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * t2))


def eval_disney(ic, wo, wi):
    """The reflective Disney lobes (thin, specular_trans and diffuse_trans
    are 0 in the fused kernel). ic: c0 color, c1 sheen * csheen, c2 cspec0,
    c3 tint mix, p0 eta, p1 roughness, d0 metallic, d1 clearcoat alpha, d2
    clearcoat, d3 / d4 / d5 the normalized lobe weights."""
    wol_x, wol_y, wol_z = wo
    wil_x, wil_y, wil_z = wi
    ax, ay = ic["ax"], ic["ay"]
    met = ic["d0"]
    same = wol_z * wil_z > 0.0
    cos_o = torch.abs(wol_z)
    cos_i = torch.abs(wil_z)
    hx, hy, hz = normalize3(wol_x + wil_x, wol_y + wil_y, wol_z + wil_z)
    neg_h = hz < 0.0
    hx, hy, hz = where(neg_h, -hx, hx), where(neg_h, -hy, hy), where(neg_h, -hz, hz)
    cos_d = wil_x * hx + wil_y * hy + wil_z * hz

    fo = schlick_w(cos_o)
    fi = schlick_w(cos_i)
    f_diffuse_s = (1.0 - 0.5 * fo) * (1.0 - 0.5 * fi)
    rr = 2.0 * ic["p1"] * cos_d * cos_d
    f_retro_s = rr * (fo + fi + fo * fi * (rr - 1.0))
    dw = 1.0 - met
    diff_s = INV_PI * (f_diffuse_s + f_retro_s) * dw
    sheen_s = schlick_w(torch.abs(cos_d)) * dw

    d = ggx_d(hx, hy, hz, ax, ay)
    g = ggx_g(wol_x, wol_y, wol_z, wil_x, wil_y, wil_z, ax, ay)
    f_diel = fres_dielectric(cos_d, ic["p0"])
    spec_s = d * g / torch.clamp(4.0 * cos_o * cos_i, min=1e-6)

    d_cc = gtr1(torch.abs(hz), ic["d1"])
    f_cc_s = 0.04 + 0.96 * schlick_w(cos_d)
    g_cc = _smith_g_sep_z(wol_z, 0.25) * _smith_g_sep_z(wil_z, 0.25)
    cc = ic["d2"] * 0.25 * d_cc * f_cc_s * g_cc / torch.clamp(4.0 * cos_o * cos_i, min=1e-6)

    valid_r = same & (cos_i > 1e-6) & (cos_o > 1e-6)
    f = []
    for c in "rgb":
        fres = (1.0 - met) * f_diel * ic["c3" + c] + met * fres_schlick_1(cos_d, ic["c2" + c])
        fc = ic["c0" + c] * diff_s + ic["c1" + c] * sheen_s + fres * spec_s + cc
        f.append(where(valid_r, fc * cos_i, 0.0))

    dot_oh = wol_x * hx + wol_y * hy + wol_z * hz
    pdf_spec = ggx_pdf(wol_x, wol_y, wol_z, hx, hy, hz, ax, ay) / torch.clamp(
        4.0 * torch.abs(dot_oh), min=1e-6
    )
    pdf_cc = d_cc * torch.abs(hz) / torch.clamp(4.0 * torch.abs(dot_oh), min=1e-6)
    pdf = ic["d3"] * (cos_i * INV_PI) + ic["d4"] * pdf_spec + ic["d5"] * pdf_cc
    return f[0], f[1], f[2], where(same & (cos_o > 1e-6), pdf, 0.0)


def eval_type(t, ic, wo, wi):
    if t == ST_MATTE:
        return eval_matte(ic, wo, wi)
    if t in (ST_MIRROR, ST_METAL):
        return eval_mirror_metal(ic, wo, wi, metal=t == ST_METAL)
    if t == ST_PLASTIC:
        return eval_plastic(ic, wo, wi)
    if t == ST_GLASS:
        return eval_glass(ic, wo, wi)
    if t == ST_DISNEY:
        return eval_disney(ic, wo, wi)
    raise AssertionError(t)


def _reflect(d, hx, hy, hz, wx, wy, wz):
    return 2.0 * d * hx - wx, 2.0 * d * hy - wy, 2.0 * d * hz - wz


def sample_type(t, ic, wo, u_lobe, u0, u1):
    """Direction sample of one surface type in the local frame:
    ((wx, wy, wz), event, eta, valid)."""
    wol_x, wol_y, wol_z = wo
    zero = torch.zeros_like(wol_x)
    event = zero
    eta = zero + 1.0
    valid = zero < 1.0
    if t == ST_MATTE:
        ddx, ddy = concentric_disk(u0, u1)
        dz_l = torch.sqrt(torch.clamp(1.0 - ddx * ddx - ddy * ddy, min=0.0))
        return (ddx, ddy, where(wol_z < 0.0, -dz_l, dz_l)), event, eta, valid
    if t in (ST_MIRROR, ST_METAL):
        hx, hy, hz = ggx_sample_wh(wol_x, wol_y, wol_z, u0, u1, ic["ax"], ic["ay"])
        d = wol_x * hx + wol_y * hy + wol_z * hz
        return _reflect(d, hx, hy, hz, wol_x, wol_y, wol_z), event, eta, valid
    if t == ST_PLASTIC:
        neg = wol_z < 0.0
        fz = where(neg, -wol_z, wol_z)
        pick_diffuse = u_lobe < plastic_substrate_weight(
            ic, fres_dielectric(torch.abs(fz), ic["p0"])
        )
        ddx, ddy = concentric_disk(u0, u1)
        dz_l = torch.sqrt(torch.clamp(1.0 - ddx * ddx - ddy * ddy, min=0.0))
        hx, hy, hz = ggx_sample_wh(wol_x, wol_y, fz, u0, u1, ic["ax"], ic["ay"])
        d = wol_x * hx + wol_y * hy + fz * hz
        cx, cy, cz = _reflect(d, hx, hy, hz, wol_x, wol_y, fz)
        wz = where(pick_diffuse, dz_l, cz)
        return (
            (where(pick_diffuse, ddx, cx), where(pick_diffuse, ddy, cy), where(neg, -wz, wz)),
            event, eta, valid,
        )
    if t == ST_GLASS:
        eta_t = ic["p0"]
        pick_refl = u_lobe < glass_refl_prob(ic, fres_dielectric(wol_z, eta_t))
        hx, hy, hz = ggx_sample_wh(wol_x, wol_y, wol_z, u0, u1, ic["ax"], ic["ay"])
        neg_o = wol_z < 0.0
        hx, hy, hz = where(neg_o, -hx, hx), where(neg_o, -hy, hy), where(neg_o, -hz, hz)
        d = wol_x * hx + wol_y * hy + wol_z * hz
        rx, ry, rz = _reflect(d, hx, hy, hz, wol_x, wol_y, wol_z)
        eta_rel_in = where(wol_z > 0.0, 1.0 / eta_t, eta_t)
        negd = d < 0.0
        ok_t, (ttx, tty, ttz) = refract_c(
            wol_x, wol_y, wol_z,
            where(negd, -hx, hx), where(negd, -hy, hy), where(negd, -hz, hz), eta_rel_in,
        )
        event = where(
            pick_refl, float(EVENT_REFLECT),
            where(wol_z > 0.0, float(EVENT_ENTER), float(EVENT_EXIT)),
        )
        return (
            (where(pick_refl, rx, ttx), where(pick_refl, ry, tty), where(pick_refl, rz, ttz)),
            event, zero + eta_t, pick_refl | ok_t,
        )
    if t == ST_DISNEY:
        pick_diff = u_lobe < ic["d3"]
        pick_spec = (~pick_diff) & (u_lobe < ic["d3"] + ic["d4"])
        sign = where(wol_z < 0.0, -1.0, 1.0)
        ddx, ddy = concentric_disk(u0, u1)
        dz_l = torch.sqrt(torch.clamp(1.0 - ddx * ddx - ddy * ddy, min=0.0))
        hx, hy, hz = ggx_sample_wh(wol_x, wol_y, wol_z, u0, u1, ic["ax"], ic["ay"])
        neg_o = wol_z < 0.0
        shx, shy, shz = where(neg_o, -hx, hx), where(neg_o, -hy, hy), where(neg_o, -hz, hz)
        d_s = wol_x * shx + wol_y * shy + wol_z * shz
        sx_, sy_, sz_ = _reflect(d_s, shx, shy, shz, wol_x, wol_y, wol_z)
        a2 = ic["d1"] * ic["d1"]
        cos_h = torch.sqrt(torch.clamp(
            (1.0 - torch.pow(torch.clamp(a2, min=1e-12), 1.0 - u0))
            / torch.clamp(1.0 - a2, min=1e-6),
            min=0.0,
        ))
        sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
        phi = 2.0 * PI * u1
        chx = sin_h * torch.cos(phi)
        chy = sin_h * torch.sin(phi)
        chz = cos_h * sign
        d_c = wol_x * chx + wol_y * chy + wol_z * chz
        cx_, cy_, cz_ = _reflect(d_c, chx, chy, chz, wol_x, wol_y, wol_z)
        w = (
            where(pick_diff, ddx, where(pick_spec, sx_, cx_)),
            where(pick_diff, ddy, where(pick_spec, sy_, cy_)),
            where(pick_diff, dz_l * sign, where(pick_spec, sz_, cz_)),
        )
        return w, event, zero + ic["p0"], valid
    raise AssertionError(t)
