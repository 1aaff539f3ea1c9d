"""Monte-Carlo sampling primitives and alias tables.

Counterpart of luisarender_tpu/core/sampling.py: triangle, cosine
hemisphere, sphere and cone sampling, the balance heuristic, and Vose alias
tables, 1D and the 2D (marginal rows, conditional columns) of environment
maps (built on the host with numpy, sampled on the device).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

INV_PI = 1.0 / math.pi
PI = math.pi


def sample_uniform_triangle(u):
    """u: (..., 2) -> barycentric (..., 2) (b0, b1), square-root warp."""
    su = torch.sqrt(torch.clamp(u[..., 0], min=0.0))
    b0 = 1.0 - su
    b1 = u[..., 1] * su
    return torch.stack([b0, b1], dim=-1)


def sample_uniform_disk_concentric(u):
    """Concentric (Shirley) disk mapping; u: (..., 2) -> (..., 2)."""
    ux = 2.0 * u[..., 0] - 1.0
    uy = 2.0 * u[..., 1] - 1.0
    zero = (ux == 0.0) & (uy == 0.0)
    use_x = torch.abs(ux) > torch.abs(uy)
    r = torch.where(use_x, ux, uy)

    def safe(num, den):
        return num / torch.where(den == 0.0, 1.0, den)

    theta = torch.where(
        use_x, (PI / 4.0) * safe(uy, ux), (PI / 2.0) - (PI / 4.0) * safe(ux, uy)
    )
    p = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], 0.0, p)


def sample_cosine_hemisphere(u):
    """Cosine-weighted hemisphere (z-up); u: (..., 2) -> (..., 3)."""
    d = sample_uniform_disk_concentric(u)
    dx, dy = d[..., 0], d[..., 1]
    z = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))
    return torch.stack([dx, dy, z], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def sample_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


UNIFORM_SPHERE_PDF = 1.0 / (4.0 * PI)


def sample_uniform_cone(u, cos_theta_max):
    cos_t = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def uniform_cone_pdf(cos_theta_max):
    """cos_theta_max: a float32 tensor."""
    return 1.0 / (2.0 * PI * torch.clamp(1.0 - cos_theta_max, min=1e-8))


def balance_heuristic(pdf_a, pdf_b):
    return pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-20)


class AliasTable(NamedTuple):
    """prob / alias / normalized pdf, all shape (n,)."""

    prob: np.ndarray  # float32: probability of keeping bucket i
    alias: np.ndarray  # int32: alias bucket
    pdf: np.ndarray  # float32: normalized pdf of entry i


def build_alias_table(weights: np.ndarray) -> AliasTable:
    """Host-side Vose O(n) construction over non-negative weights."""
    w = np.asarray(weights, dtype=np.float64).ravel()
    n = w.size
    if n == 0:
        raise ValueError("alias table over empty weights")
    w = np.maximum(w, 0.0)
    total = w.sum()
    if total <= 0.0:
        w = np.ones_like(w)
        total = float(n)
    pdf = w / total
    scaled = pdf * n
    prob = np.ones(n, dtype=np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return AliasTable(
        prob=prob.astype(np.float32),
        alias=alias.astype(np.int32),
        pdf=pdf.astype(np.float32),
    )


def alias_sample(prob, alias, pdf, u):
    """Sample index ~ pdf from uniform u, given a table's (prob, alias, pdf)
    as device tensors; returns (index, pdf, u_remapped), u_remapped being the
    used uniform recycled back to [0, 1)."""
    n = prob.shape[0]
    ux = u * n
    i = torch.clamp(ux.to(torch.int32), 0, n - 1)
    up = ux - i.to(torch.float32)
    prob_i = prob[i]
    take_alias = up >= prob_i
    index = torch.where(take_alias, alias[i], i)
    u_remapped = torch.where(
        take_alias,
        (up - prob_i) / torch.clamp(1.0 - prob_i, min=1e-8),
        up / torch.clamp(prob_i, min=1e-8),
    )
    u_remapped = torch.clamp(u_remapped, 0.0, 1.0 - 2.0 ** -24)
    return index, pdf[index], u_remapped


class AliasTable2D(NamedTuple):
    """Marginal table over rows (h,) and per-row conditional tables (h, w)."""

    marginal: AliasTable
    cond_prob: np.ndarray  # (h, w) float32
    cond_alias: np.ndarray  # (h, w) int32
    cond_pdf: np.ndarray  # (h, w) float32


def build_alias_table_2d(weights_2d: np.ndarray) -> AliasTable2D:
    w = np.asarray(weights_2d, dtype=np.float64)
    h, wd = w.shape
    marginal = build_alias_table(w.sum(axis=1))
    cp = np.zeros((h, wd), dtype=np.float32)
    ca = np.zeros((h, wd), dtype=np.int32)
    cpdf = np.zeros((h, wd), dtype=np.float32)
    for y in range(h):
        t = build_alias_table(w[y])
        cp[y], ca[y], cpdf[y] = t.prob, t.alias, t.pdf
    return AliasTable2D(marginal=marginal, cond_prob=cp, cond_alias=ca, cond_pdf=cpdf)


def alias_sample_2d(marg_prob, marg_alias, marg_pdf, cond_prob, cond_alias, cond_pdf, u):
    """u: (..., 2) -> (x, y, pdf over the h * w texel grid), the tables as
    device tensors."""
    y, pdf_y, _ = alias_sample(marg_prob, marg_alias, marg_pdf, u[..., 1])
    w = cond_prob.shape[1]
    ux = u[..., 0] * w
    xi = torch.clamp(ux.to(torch.int32), 0, w - 1)
    up = ux - xi.to(torch.float32)
    prob_i = cond_prob[y, xi]
    x = torch.where(up >= prob_i, cond_alias[y, xi], xi)
    return x, y, pdf_y * cond_pdf[y, x]
