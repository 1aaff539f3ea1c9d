"""Spherical (lat-long) environment map with alias-table importance
sampling.

Counterpart of luisarender_tpu/environments/spherical.py: the emission
texture is rasterized to a radiance grid at compile time; the sampling
weights are its 3x3-blurred luminance times sin(theta), less the optional
MIS compensation; a marginal and per-row conditional alias table
(core/sampling.py build_alias_table_2d) sample texels, and the directional
pdf is p_texel * w * h / (2 pi^2 sin(theta)). A constant map samples the
uniform sphere instead. Equal-angle parameterization: u = phi / 2 pi
(phi around +y, from +x towards +z), v = theta / pi (theta from +y).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import sampling
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from .base import Environment

PI = math.pi


def direction_to_uv(w):
    theta = torch.arccos(torch.clamp(w[..., 1], -1.0, 1.0))
    phi = torch.atan2(w[..., 2], w[..., 0])
    u = torch.remainder(phi / (2.0 * PI), 1.0)
    v = theta / PI
    return torch.stack([u, v], dim=-1)


def uv_to_direction(uv):
    phi = uv[..., 0] * 2.0 * PI
    theta = uv[..., 1] * PI
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)], dim=-1)


def _bilinear(img, uv):
    """img (H, W, C); uv (..., 2) in [0, 1): wraps in u, clamps in v."""
    h, w = img.shape[0], img.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0.to(torch.float32))[..., None]
    fy = (y - y0.to(torch.float32))[..., None]
    x0w = torch.remainder(x0, w)
    x1w = torch.remainder(x0 + 1, w)
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    v00 = img[y0c, x0w]
    v01 = img[y0c, x1w]
    v10 = img[y1c, x0w]
    v11 = img[y1c, x1w]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _rotate_t(rot, w):
    """rot^T w, written out (world -> the map's frame)."""
    return torch.stack([
        rot[0, 0] * w[..., 0] + rot[1, 0] * w[..., 1] + rot[2, 0] * w[..., 2],
        rot[0, 1] * w[..., 0] + rot[1, 1] * w[..., 1] + rot[2, 1] * w[..., 2],
        rot[0, 2] * w[..., 0] + rot[1, 2] * w[..., 1] + rot[2, 2] * w[..., 2],
    ], dim=-1)


def _rotate(rot, w):
    """rot w, written out (the map's frame -> world)."""
    return torch.stack([
        rot[0, 0] * w[..., 0] + rot[0, 1] * w[..., 1] + rot[0, 2] * w[..., 2],
        rot[1, 0] * w[..., 0] + rot[1, 1] * w[..., 1] + rot[1, 2] * w[..., 2],
        rot[2, 0] * w[..., 0] + rot[2, 1] * w[..., 1] + rot[2, 2] * w[..., 2],
    ], dim=-1)


@register(SceneNodeTag.ENVIRONMENT, "spherical", "Spherical")
class SphericalEnvironment(Environment):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        emission = desc.node("emission")
        if emission is None:
            raise ValueError("spherical environment requires 'emission' texture")
        self.emission = scene.load_texture(emission)
        self.mis_compensation = desc.float("mis_compensation", 0.0)
        self.constant = True
        self._arrays = None

    def compile(self, compiler):
        img = np.asarray(self._rasterize(), np.float32)
        h = img.shape[0]
        lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
        self.constant = bool(lum.max() - lum.min() < 1e-6 * max(lum.max(), 1e-12))
        k = np.asarray([0.25, 0.5, 0.25])
        blurred = np.roll(lum, -1, 0) * k[0] + lum * k[1] + np.roll(lum, 1, 0) * k[2]
        blurred = np.roll(blurred, -1, 1) * k[0] + blurred * k[1] + np.roll(blurred, 1, 1) * k[2]
        theta = (np.arange(h) + 0.5) / h * PI
        weights = blurred * np.sin(theta)[:, None]
        if self.mis_compensation > 0.0:
            weights = np.maximum(weights - self.mis_compensation * weights.mean(), 0.0)
        if weights.sum() <= 0.0:
            weights = np.ones_like(weights)
        table = sampling.build_alias_table_2d(weights)
        self._arrays = {
            "image": img,
            "mean": np.asarray(img.mean(axis=(0, 1)), np.float32),
            "marg_prob": table.marginal.prob,
            "marg_alias": table.marginal.alias,
            "marg_pdf": table.marginal.pdf,
            "cond_prob": table.cond_prob,
            "cond_alias": table.cond_alias,
            "cond_pdf": table.cond_pdf,
            "rotation": np.asarray(self.rotation(), np.float32),
        }

    def _rasterize(self) -> np.ndarray:
        """Radiance grid of the emission texture: a constant one is a 64 x 128
        grid of its value; an image or sky texture gives its own grid
        (`rasterize`)."""
        static = self.emission.evaluate_static()
        if static is not None:
            img = np.broadcast_to(np.asarray(static[:3], np.float32), (64, 128, 3)).copy()
            return img * self.scale
        raster = getattr(self.emission, "rasterize", None)
        if raster is None:
            raise ValueError(
                f"environment emission texture '{self.emission.impl_type}' cannot be rasterized")
        return np.asarray(raster(), np.float32)[..., :3] * self.scale

    def device_arrays(self):
        return self._arrays

    # --- device side ---
    @staticmethod
    def _pdf_dir(env, uv, pdf_texel):
        h, w = env["image"].shape[0], env["image"].shape[1]
        sin_t = torch.sin(torch.clamp(uv[..., 1], 1e-4, 1.0 - 1e-4) * PI)
        return pdf_texel * (h * w) / (2.0 * PI * PI * torch.clamp(sin_t, min=1e-6))

    def evaluate(self, ctx, wi_world, swl):
        env = ctx.arrays["environment"]
        uv = direction_to_uv(_rotate_t(env["rotation"], wi_world))
        n = uv.shape[0]
        if self.constant:
            # a constant map: the mean and the uniform-sphere pdf
            rgb = env["mean"].expand(n, 3)
            pdf = torch.full((n,), sampling.UNIFORM_SPHERE_PDF, dtype=torch.float32,
                             device=uv.device)
        else:
            rgb = _bilinear(env["image"], uv)
            h, w = env["image"].shape[0], env["image"].shape[1]
            xi = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)
            yi = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1)
            pdf_texel = env["marg_pdf"][yi] * env["cond_pdf"][yi, xi]
            pdf = self._pdf_dir(env, uv, pdf_texel)
        return {"L": ctx.spectrum.decode_illuminant(rgb, swl), "pdf": pdf}

    def sample(self, ctx, p, u, swl):
        env = ctx.arrays["environment"]
        n = u.shape[0]
        if self.constant:
            wi_local = sampling.sample_uniform_sphere(u)
            pdf = torch.full((n,), sampling.UNIFORM_SPHERE_PDF, dtype=torch.float32,
                             device=u.device)
            rgb = env["mean"].expand(n, 3)
        else:
            h, w = env["image"].shape[0], env["image"].shape[1]
            y, pdf_y, uy = sampling.alias_sample(
                env["marg_prob"], env["marg_alias"], env["marg_pdf"], u[..., 1])
            ux = u[..., 0] * w
            xi = torch.clamp(ux.to(torch.int32), 0, w - 1)
            up = ux - xi.to(torch.float32)
            prob_i = env["cond_prob"][y, xi]
            take = up >= prob_i
            x = torch.where(take, env["cond_alias"][y, xi], xi)
            ux_rem = torch.where(
                take,
                (up - prob_i) / torch.clamp(1.0 - prob_i, min=1e-8),
                up / torch.clamp(prob_i, min=1e-8),
            )
            pdf_texel = pdf_y * env["cond_pdf"][y, x]
            uv = torch.stack([
                (x.to(torch.float32) + torch.clamp(ux_rem, 0.0, 1.0)) / w,
                (y.to(torch.float32) + torch.clamp(uy, 0.0, 1.0)) / h,
            ], dim=-1)
            wi_local = uv_to_direction(uv)
            pdf = self._pdf_dir(env, uv, pdf_texel)
            rgb = _bilinear(env["image"], uv)
        wi_world = _rotate(env["rotation"], wi_local)
        return {"wi": wi_world, "L": ctx.spectrum.decode_illuminant(rgb, swl), "pdf": pdf}
