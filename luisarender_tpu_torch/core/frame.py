"""Orthonormal shading frames and local trigonometry.

Counterpart of luisarender_tpu/core/frame.py. Vectors are (..., 3) float32
tensors and frames are dicts of three such tensors. Dot products and cross
products are written out term by term, in the reference's order, so the two
packages round alike.
"""

from __future__ import annotations

import torch


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v, eps=1e-20):
    return v / torch.clamp(length(v), min=eps)[..., None]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def reflect(wo, n):
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Refract wi about n with relative IOR eta = eta_i / eta_t; returns
    (valid, wt)."""
    cos_i = dot(n, wi)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    valid = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = eta[..., None] * -wi + (eta * cos_i - cos_t)[..., None] * n
    return valid, wt


def make_frame(n):
    """Branchless orthonormal frame around unit normal n (Duff et al. 2017)."""
    nz = n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1,
    )
    t = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return {"s": s, "t": t, "n": n}


def frame_from_z_and_hint(n, tangent_hint):
    """Frame with s aligned (Gram-Schmidt) to a dpdu tangent hint."""
    s = tangent_hint - dot(tangent_hint, n)[..., None] * n
    s_len = length(s)
    fallback = make_frame(n)
    ok = (s_len > 1e-8)[..., None]
    s = torch.where(ok, s / torch.clamp(s_len, min=1e-20)[..., None], fallback["s"])
    t = torch.where(ok, cross(n, s), fallback["t"])
    return {"s": s, "t": t, "n": n}


def to_local(frame, v):
    return torch.stack(
        [dot(v, frame["s"]), dot(v, frame["t"]), dot(v, frame["n"])], dim=-1
    )


def to_world(frame, v):
    return (
        v[..., 0:1] * frame["s"] + v[..., 1:2] * frame["t"] + v[..., 2:3] * frame["n"]
    )


# --- local-space trig (z-up shading space) ---


def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return torch.sqrt(sin2_theta(w))


def cos_phi(w):
    s = sin_theta(w)
    return torch.where(
        s == 0.0, 1.0,
        torch.clamp(w[..., 0] / torch.clamp(s, min=1e-20), -1.0, 1.0),
    )


def sin_phi(w):
    s = sin_theta(w)
    return torch.where(
        s == 0.0, 0.0,
        torch.clamp(w[..., 1] / torch.clamp(s, min=1e-20), -1.0, 1.0),
    )


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0
