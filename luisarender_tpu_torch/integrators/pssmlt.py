"""Primary-sample-space Metropolis light transport (Kelemen-style).

Counterpart of luisarender_tpu/integrators/pssmlt.py. A chain's state is
its primary-sample vector u (dims = 4 + 8 depth numbers): dims 0-1 pick the
pixel, the rest feed the path through PSSSampler, so the path is a function
of u and the chain's target is the luminance of its radiance. The general
fork traces every batch of paths: PSSSampler is not the independent
sampler, so a PSSMLT path never takes the fused kernel.

  bootstrap  bootstrap // chains rounds of fresh vectors (salt 1000 + r),
             b = the mean of the rounds' mean luminances; each chain starts
             from its round of largest luminance (the first of equals);
  mutate     spp * pixels // chains Kelemen steps (salt 2,000,003 + m):
             a large step (p_large, salt word 7) draws every dimension
             afresh, a small one moves it by +-dv (1/1024 to 1/64,
             exponentially distributed) modulo 1; the proposal is
             accepted with probability min(1, lum' / lum) (salt word 13);
  splat      both states each step, the proposal weighted a / lum', the
             current (1 - a) / lum, into the image, which ends scaled by
             b * pixels / (chains * steps).

The draws are hashes of (chain, dimension, salt) (core/rng.py xxhash32), as
in the reference; the splat adds by index_put_ with accumulate=True, whose
order on the card is not fixed.
"""

from __future__ import annotations

import logging
import time as _time

import numpy as np
import torch

from ..core import rng
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..utils import imageio
from .base import Integrator
from .mega_path import path_trace_batch

log = logging.getLogger("luisarender_tpu_torch")

BOOTSTRAP_SALT = 1000
MUTATION_SALT = 2_000_003


class PSSSampler:
    """A sampler that replays the primary-sample matrix `current_u` (N, D),
    a dimension a draw, the same for every lane; dimensions from D on are
    xxhash32(chain, dimension, salt) of the lane's chain index."""

    def __init__(self, dims: int):
        self.dims = dims
        self.current_u = None  # (N, D), set by the integrator for each trace

    def start(self, pixel_xy, sample_index):
        n = pixel_xy.shape[0]
        return {"dim": 0, "chain": torch.arange(n, dtype=torch.int64, device=pixel_xy.device),
                "salt": int(sample_index)}

    def generate_1d(self, state):
        d = state["dim"]
        if d < self.dims:
            u = self.current_u[:, d]
        else:
            u = rng.uniform_u32_to_float(rng.xxhash32(state["chain"], d, state["salt"]))
        return {**state, "dim": d + 1}, u

    def generate_2d(self, state):
        state, a = self.generate_1d(state)
        state, b = self.generate_1d(state)
        return state, torch.stack([a, b], dim=-1)

    def generate_pixel_2d(self, state):
        return self.generate_2d(state)


def uniform_block(salt, n, d, device):
    """(n, d) uniforms: element (i, j) from xxhash32(i, j, salt)."""
    ids = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    return rng.uniform_u32_to_float(rng.xxhash32(ids, cols, salt))


def chain_uniform(salt, word, n, device):
    """(n,) uniforms xxhash32(chain, salt, word): the large-step and
    acceptance draws of a mutation."""
    ids = torch.arange(n, dtype=torch.int64, device=device)
    return rng.uniform_u32_to_float(rng.xxhash32(ids, salt, word))


def mutate(u, u_rand, pick_large):
    """Kelemen mutation of every dimension: u_rand itself (a large step),
    else u +- dv modulo 1 (floored), dv = 1/64 exp(-log(16) |2 u_rand - 1|),
    + where u_rand < 0.5."""
    s1, s2 = 1.0 / 1024.0, 1.0 / 64.0
    dv = s2 * torch.exp(-np.float32(np.log(s2 / s1)) * torch.abs(2.0 * u_rand - 1.0))
    small = torch.where(u_rand < 0.5, torch.remainder(u + dv, 1.0),
                        torch.remainder(u - dv, 1.0))
    return torch.where(pick_large[..., None], u_rand, small)


@register(SceneNodeTag.INTEGRATOR, "pssmlt", "PSSMLT", "mlt", "MLT")
class PSSMLT(Integrator):
    """Defaults: depth 10, rr_depth 0, rr_threshold 0.95, 16,384 chains,
    a bootstrap of 65,536 paths, p_large 0.3 (sigma 5e-3 is read and, as in
    the reference, unused: the small step's profile is fixed)."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.max_depth = desc.int("depth", 10)
        self.rr_depth = desc.int("rr_depth", 0)
        self.rr_threshold = desc.float("rr_threshold", 0.95)
        self.chains = desc.int("chains", 1 << 14)
        self.bootstrap = desc.int("bootstrap", 1 << 16)
        self.p_large = desc.float("p_large", 0.3)
        self.sigma = desc.float("sigma", 5e-3)
        # totals of the last render(): paths traced (bootstrap, first
        # states, proposals) and mutation steps
        self.paths_traced = 0
        self.mutations_run = 0

    def dims(self):
        return 4 + 8 * self.max_depth

    def trace(self, compiled, camera, sampler, u):
        """(rgb (N, 3), luminance (N,), pixel (N, 2) int32) of the paths of
        the primary-sample vectors u (N, D); non-finite values read 0."""
        w, h = camera.film.resolution
        px = torch.clamp((u[..., 0] * w).to(torch.int32), 0, w - 1)
        py = torch.clamp((u[..., 1] * h).to(torch.int32), 0, h - 1)
        pixel_xy = torch.stack([px, py], dim=-1)
        sampler.current_u = u[..., 2:]
        rgb, _ = path_trace_batch(compiled, camera, sampler, self.light_sampler, pixel_xy, 0,
                                  max_depth=self.max_depth, rr_depth=self.rr_depth,
                                  rr_threshold=self.rr_threshold)
        self.paths_traced += u.shape[0]
        lum = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
        lum = torch.where(torch.isfinite(lum), lum, 0.0)
        rgb = torch.where(torch.isfinite(rgb), rgb, 0.0)
        return rgb, lum, pixel_xy

    def bootstrap_chains(self, compiled, camera, sampler):
        """(b, u0): the mean luminance of the bootstrap rounds (a float32
        tensor) and each chain's first state (chains, dims)."""
        dev = compiled.device
        rounds = max(self.bootstrap // self.chains, 1)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        lums, us = [], []
        for r in range(rounds):
            u = uniform_block(BOOTSTRAP_SALT + r, self.chains, self.dims(), dev)
            _, lum, _ = self.trace(compiled, camera, sampler, u)
            total = total + lum.mean()
            lums.append(lum)
            us.append(u)
        pick = torch.argmax(torch.stack(lums), dim=0)
        u0 = torch.stack(us)[pick, torch.arange(self.chains, device=dev)]
        return total / rounds, u0

    def mutate_step(self, compiled, camera, sampler, splat, state, salt):
        """One mutation of every chain with its splats: (splat, state),
        state = (u, rgb, lum, pixel)."""
        u, rgb, lum, pix = state
        dev = u.device
        u_rand = uniform_block(salt, self.chains, self.dims(), dev)
        pick_large = chain_uniform(salt, 7, self.chains, dev) < self.p_large
        u_prop = mutate(u, u_rand, pick_large)
        rgb_p, lum_p, pix_p = self.trace(compiled, camera, sampler, u_prop)
        a = torch.clamp(lum_p / torch.clamp(lum, min=1e-12), 0.0, 1.0)
        accept = chain_uniform(salt, 13, self.chains, dev) < a
        # both states splatted (Kelemen): the proposal by a, the current by 1 - a
        w_prop = torch.where(lum_p > 0, a / torch.clamp(lum_p, min=1e-12), 0.0)
        w_cur = torch.where(lum > 0, (1.0 - a) / torch.clamp(lum, min=1e-12), 0.0)
        splat.index_put_((pix_p[..., 1].long(), pix_p[..., 0].long()),
                         rgb_p * w_prop[..., None], accumulate=True)
        splat.index_put_((pix[..., 1].long(), pix[..., 0].long()),
                         rgb * w_cur[..., None], accumulate=True)
        a1, a3 = accept, accept[..., None]
        self.mutations_run += 1
        return splat, (torch.where(a3, u_prop, u), torch.where(a3, rgb_p, rgb),
                       torch.where(a1, lum_p, lum), torch.where(a3, pix_p, pix))

    def _render_one_camera(self, compiled, camera):
        w, h = camera.film.resolution
        n_pixels = w * h
        sampler = PSSSampler(self.dims() - 2)
        b, u = self.bootstrap_chains(compiled, camera, sampler)
        b = float(b)  # a host read
        if b <= 0.0:
            return torch.zeros((h, w, 3), dtype=torch.float32, device=compiled.device)
        rgb0, lum0, pix0 = self.trace(compiled, camera, sampler, u)
        total_mutations = max((camera.spp * n_pixels) // self.chains, 1)
        splat = torch.zeros((h, w, 3), dtype=torch.float32, device=compiled.device)
        state = (u, rgb0, lum0, pix0)
        for m in range(total_mutations):
            splat, state = self.mutate_step(compiled, camera, sampler, splat, state,
                                            MUTATION_SALT + m)
        # E_pi[f / lum] b: the image's mean over pixels and mutations
        return splat * (b * n_pixels / (self.chains * total_mutations))

    def render(self, compiled, save: bool = False) -> dict:
        results = {}
        self.paths_traced = self.mutations_run = 0
        for camera in compiled.scene.cameras:
            t0 = _time.time()
            image = self._render_one_camera(compiled, camera).cpu().numpy()
            log.info("pssmlt rendered %s in %.2fs", camera.file, _time.time() - t0)
            results[camera.file] = image
            if save:
                imageio.save_image(camera.file, image)
        return results
