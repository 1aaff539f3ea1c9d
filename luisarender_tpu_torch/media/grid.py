"""Heterogeneous (density-grid) medium with delta and ratio tracking.

Counterpart of luisarender_tpu/media/grid.py. The density is a trilinear
grid, z-major (`grid[g, z, y, x]`), over world-space bounds and 0 outside
them; the majorant is the grid's largest density times the largest
sigma_t. Distance sampling is delta tracking with a spectral MIS over the
channels, transmittance ratio tracking, each at most MAX_TRACKING_STEPS
majorant steps, the step's randoms xxhash32(seed, step, 0x7A11 / 0xD157 /
0xC011).

The reference steps its loops while any lane of the batch is alive, with one
shared step count, and every update is masked by the lane's own alive flag,
so a lane that has finished never changes. dispatch (media/base.py) hands
these closures only the lanes whose medium is a grid, and the loops read the
alive flag to the host every CHECK_EVERY steps, not every step: the steps
past the last live lane change nothing, so each lane's result is the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from . import base
from .base import Medium, load_phase, phase_g, sigmas

MAX_TRACKING_STEPS = 256
# steps between host reads of the tracking loops' alive flags
CHECK_EVERY = 8


def _density(params, ctx, p):
    """Trilinear grid density at world positions p (N, 3); 0 outside the
    bounds."""
    grids = ctx.arrays["density_grids"]  # (G, D, H, W)
    dims = ctx.arrays["density_grid_dims"]  # (G, 3) int32 (D, H, W)
    gid = params["grid_id"].to(torch.int64)
    bmin = params["bounds_min"]
    ext = torch.clamp(params["bounds_max"] - bmin, min=1e-8)
    uvw = (p - bmin) / ext
    inside = ((uvw >= 0.0) & (uvw <= 1.0)).all(dim=-1)
    d = dims[gid].to(torch.int64)
    fz = torch.clamp(uvw[..., 2], 0.0, 1.0) * (d[..., 0] - 1)
    fy = torch.clamp(uvw[..., 1], 0.0, 1.0) * (d[..., 1] - 1)
    fx = torch.clamp(uvw[..., 0], 0.0, 1.0) * (d[..., 2] - 1)
    z0 = torch.floor(fz).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    x0 = torch.floor(fx).to(torch.int64)
    z1 = torch.minimum(z0 + 1, d[..., 0] - 1)
    y1 = torch.minimum(y0 + 1, d[..., 1] - 1)
    x1 = torch.minimum(x0 + 1, d[..., 2] - 1)
    wz, wy, wx = fz - z0, fy - y0, fx - x0

    def at(z, y, x):
        return grids[gid, z, y, x]

    c00 = at(z0, y0, x0) * (1 - wx) + at(z0, y0, x1) * wx
    c01 = at(z0, y1, x0) * (1 - wx) + at(z0, y1, x1) * wx
    c10 = at(z1, y0, x0) * (1 - wx) + at(z1, y0, x1) * wx
    c11 = at(z1, y1, x0) * (1 - wx) + at(z1, y1, x1) * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return torch.where(inside, c0 * (1 - wz) + c1 * wz, 0.0)


def _track(state, body, seed, salts):
    """Run body(state, *u) -> state from step 0 while a lane is alive
    (state["alive"]), at most MAX_TRACKING_STEPS steps, reading the flag to
    the host every CHECK_EVERY steps; u: the step's uniform a lane for each
    salt, xxhash32(seed, step, salt), hashed for a block of CHECK_EVERY
    steps at once."""
    for start in range(0, MAX_TRACKING_STEPS, CHECK_EVERY):
        base.host_reads += 1
        if not bool(state["alive"].any()):
            break
        steps = torch.arange(start, start + CHECK_EVERY, device=seed.device)
        us = [rng.uniform_u32_to_float(rng.xxhash32(seed[:, None], steps, salt))
              for salt in salts]
        for j in range(CHECK_EVERY):
            state = body(state, *(u[:, j] for u in us))
    return state


@register(SceneNodeTag.MEDIUM, "grid", "Grid", "heterogeneous", "Heterogeneous")
class GridMedium(Medium):
    tracks = True

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.sigma_a = tuple(desc.float3("sigma_a", (0.0, 0.0, 0.0)))
        self.sigma_s = tuple(desc.float3("sigma_s", (1.0, 1.0, 1.0)))
        self.eta = desc.float("eta", 1.0)
        self.phase = load_phase(scene, desc)
        bounds_min = desc.float3("bounds_min", None)
        bounds_max = desc.float3("bounds_max", None)
        if bounds_min is None or bounds_max is None:
            raise ValueError("grid medium requires 'bounds_min'/'bounds_max'")
        self.bounds_min = np.asarray(bounds_min, np.float32)
        self.bounds_max = np.asarray(bounds_max, np.float32)
        density = desc.float_list("density", None)
        file = desc.path("file", None)
        dims = desc.float_list("dimensions", None)
        if density is not None:
            if dims is None or len(dims) != 3:
                raise ValueError("inline grid density requires 'dimensions' (x, y, z)")
            nx, ny, nz = (int(v) for v in dims)
            self.grid = np.asarray(density, np.float32).reshape(nz, ny, nx)
        elif file is not None:
            self.grid = np.load(file).astype(np.float32)  # (D, H, W)
        else:
            raise ValueError("grid medium requires 'density' or 'file'")
        self.scale = desc.float("scale", 1.0)
        self.grid = np.maximum(self.grid * self.scale, 0.0)

    def compile(self, compiler) -> dict:
        row = {
            "sigma_a": np.asarray(self.sigma_a, np.float32),
            "sigma_s": np.asarray(self.sigma_s, np.float32),
            "eta": np.float32(self.eta),
            "priority_": np.float32(self.priority),
            "bounds_min": self.bounds_min,
            "bounds_max": self.bounds_max,
            "grid_id": np.int32(compiler.register_density_grid(self.grid)),
            "majorant_density": np.float32(float(self.grid.max())),
        }
        row.update(self.phase.compile(compiler))
        return row

    @staticmethod
    def _majorant(params, sigma_t):
        return sigma_t.amax(dim=-1) * torch.clamp(params["majorant_density"], min=1e-8)

    @staticmethod
    def transmittance(params, ctx, swl, distance, o=None, d=None, seed=None):
        """Ratio tracking along o + t d for t in [0, distance]."""
        sa, ss = sigmas(params, ctx, swl)
        sigma_t = sa + ss
        maj_sig = GridMedium._majorant(params, sigma_t)
        maj = torch.clamp(maj_sig, min=1e-8)

        def body(s, u):
            t_new = s["t"] + (-torch.log(torch.clamp(1.0 - u, min=1e-9)) / maj)
            escaped = t_new >= distance
            dens = _density(params, ctx, o + t_new[..., None] * d)
            ratio = 1.0 - dens[..., None] * sigma_t / maj[..., None]
            tr_new = s["tr"] * torch.clamp(ratio, 0.0, 1.0)
            alive = s["alive"] & ~escaped
            return {"t": torch.where(alive, t_new, s["t"]),
                    "tr": torch.where(alive[..., None], tr_new, s["tr"]),
                    "alive": alive}

        state = _track({"t": torch.zeros_like(distance),
                        "tr": torch.ones_like(sigma_t),
                        "alive": (maj_sig > 1e-9) & (distance > 0)}, body, seed, (0x7A11,))
        return state["tr"]

    @staticmethod
    def sample_distance(params, ctx, swl, t_max, u_channel, u_dist, o=None, d=None,
                        seed=None):
        """Delta tracking with a spectral MIS over the channels: one channel
        ch, picked by u_channel, decides real or null at each majorant
        event with its probability p_ch = dens sigma_t_ch / majorant; each
        channel's integrand product f_c and path pdf product pdf_c are
        carried, and the weight is f_c / mean(pdf)."""
        sa, ss = sigmas(params, ctx, swl)
        sigma_t = sa + ss
        c = sigma_t.shape[-1]
        maj_sig = GridMedium._majorant(params, sigma_t)
        maj = torch.clamp(maj_sig, min=1e-8)
        ch = torch.clamp((u_channel * c).to(torch.int64), 0, c - 1)

        def body(s, u1, u2):
            t_new = s["t"] + (-torch.log(torch.clamp(1.0 - u1, min=1e-9)) / maj)
            escaped = t_new >= t_max
            dens = _density(params, ctx, o + t_new[..., None] * d)
            p_c = torch.clamp(dens[..., None] * sigma_t / maj[..., None], 0.0, 1.0)
            p_sel = torch.gather(p_c, -1, ch[..., None])[..., 0]
            real = ~escaped & (u2 < p_sel)
            # null: f (maj - sigma_t_c) / maj, pdf 1 - p_c; real: f dens
            # sigma_s_c / maj, pdf p_c
            f_real = dens[..., None] * ss / maj[..., None]
            step_f = torch.where(real[..., None], f_real, 1.0 - p_c)
            step_pdf = torch.where(real[..., None], p_c, 1.0 - p_c)
            alive = s["alive"]
            upd = (alive & ~escaped)[..., None]
            return {"t": torch.where(alive, torch.minimum(t_new, t_max), s["t"]),
                    "f": torch.where(upd, s["f"] * step_f, s["f"]),
                    "pdf": torch.where(upd, s["pdf"] * step_pdf, s["pdf"]),
                    "scattered": s["scattered"] | (alive & real),
                    "alive": alive & ~escaped & ~real}

        state = _track({"t": torch.zeros_like(t_max), "f": torch.ones_like(sigma_t),
                        "pdf": torch.ones_like(sigma_t),
                        "scattered": torch.zeros_like(t_max, dtype=torch.bool),
                        "alive": (maj_sig > 1e-9) & (t_max > 0)}, body, seed,
                       (0xD157, 0xC011))
        weight = state["f"] / torch.clamp(state["pdf"].mean(dim=-1), min=1e-30)[..., None]
        return {"t": state["t"], "scattered": state["scattered"], "weight": weight,
                "g": phase_g(params, t_max)}
