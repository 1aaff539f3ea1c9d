"""Differentiable rendering: the image as a function of scene parameters.

Counterpart of luisarender_tpu/diff/render.py. Parameters are addressed by
paths into the compiled arrays (("textures", "constant", "value"),
("texture_atlas",), ...), and `make_render_fn` returns render(params,
base_arrays) -> (H, W, 3), which autograd differentiates:

- the pass runs the general fork's bounce step (integrators/common.py) a
  fixed `max_depth + 1` times, with no early exit and no Russian roulette,
  as the reference's `lax.scan` does; with remat=True each bounce runs
  under `torch.utils.checkpoint` (non-reentrant), the counterpart of
  `jax.checkpoint`: the backward recomputes it, trace launches included,
  instead of keeping its intermediates;
- sampling is detached (bounce_step's detach_sampling): gradients flow
  through BSDF values, textures and emission, not through sampled
  directions or pdfs; the trace wrappers pass no gradient (ops/nograd.py);
- the overridden arrays are rendered on a CompiledScene that shares every
  other tensor with the compiled one (dataclasses.replace), their constant
  textures hoisted anew into the parameter rows (scene/compiler.py
  hoist_constants), as the reference hoists them at every pass; no cone
  rides the carry, as in the reference, so an image texture reads its base
  level.

The camera and sampler draws are the reference's: the same seeds give the
same paths.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..integrators import common, mega_path
from ..scene.compiler import hoist_constants, hoist_spectral_coeffs

# the differentiable pass runs no Russian roulette (its depth is never reached)
NO_RR_DEPTH = 10_000


def set_in(tree, path, value):
    """A copy of `tree` (nested dicts and lists) with tree[path[0]][path[1]]...
    set to value; only the containers on the path are copied."""
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    out[path[0]] = value if len(path) == 1 else set_in(tree[path[0]], path[1:], value)
    return out


def get_in(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def apply_params(arrays, params: dict):
    """params: {path tuple: tensor} -> arrays with the overrides applied."""
    for path, value in params.items():
        arrays = set_in(arrays, tuple(path), value)
    return arrays


def with_arrays(compiled, arrays):
    """`compiled` rendering `arrays`: the constant textures hoisted anew
    (and, under a spectrum that is not fixed, their coefficients fitted
    anew), every other tensor shared."""
    arrays = hoist_constants(arrays, compiled.hoist_src)
    if not compiled.spectrum.is_fixed:
        arrays = hoist_spectral_coeffs(arrays, compiled.plan, compiled.spectrum)
    return dataclasses.replace(compiled, arrays=arrays)


def _bounce(compiled, sampler, light_sampler, depth, carry):
    return common.bounce_step(compiled, sampler, light_sampler, carry, max_depth=depth,
                              rr_depth=NO_RR_DEPTH, rr_threshold=0.0, detach_sampling=True)


def render_pixels(compiled, camera, integrator, pixel_xy, *, spp, max_depth, remat,
                  sample_lens=True):
    """The mean sRGB of `spp` samples (0 .. spp-1) of each pixel of pixel_xy
    (N, 2) int32, differentiable in compiled.arrays: (N, 3). sample_lens=
    False keeps u_lens at 0.5 even for a camera that samples a lens, as the
    reference's sharded pass does (parallel/render.py)."""
    sampler, light_sampler = integrator.sampler, integrator.light_sampler
    spectrum = compiled.spectrum
    n, c = pixel_xy.shape[0], compiled.plan.spectral_dim
    acc = torch.zeros((n, 3), dtype=torch.float32, device=pixel_xy.device)
    for sample_index in range(spp):
        if sample_lens:
            state, ray, cam_weight = mega_path.camera_rays(camera, sampler, pixel_xy,
                                                           sample_index)
        else:
            state = sampler.start(pixel_xy, sample_index)
            state, u_filter = sampler.generate_pixel_2d(state)
            u_lens = torch.full((n, 2), 0.5, dtype=torch.float32, device=pixel_xy.device)
            ray, _, cam_weight = camera.generate_rays(pixel_xy, u_filter, u_lens, 0.0)
        state, swl = mega_path.wavelengths(spectrum, sampler, state, pixel_xy)
        carry = common.init_carry(ray, cam_weight[..., None].expand(n, c), state, swl)
        for _ in range(max_depth + 1):
            if remat:
                # the sampler is counter-based: the recompute draws the same
                carry = checkpoint(_bounce, compiled, sampler, light_sampler, max_depth, carry,
                                   use_reentrant=False, preserve_rng_state=False)
            else:
                carry = _bounce(compiled, sampler, light_sampler, max_depth, carry)
        acc = acc + spectrum.srgb(carry["L"], carry["swl"])
    return acc / spp


def make_render_fn(compiled, camera, integrator, *, spp=4, max_depth=None, resolution=None,
                   remat=True):
    """f(params, base_arrays) -> (H, W, 3) differentiable radiance.

    params: {path: tensor} overriding entries of the compiled arrays (set
    requires_grad on the ones to differentiate). The sampler is
    deterministic in spp and pixel, so two calls with the same settings
    give correlated estimates, for finite differences and for optimizing
    against a rendered target."""
    w, h = resolution or camera.film.resolution
    depth = max_depth or getattr(integrator, "max_depth", 5)
    pixel_xy = mega_path.pixel_grid(w, h, compiled.device)

    def render(params, base_arrays):
        scene = with_arrays(compiled, apply_params(base_arrays, params))
        rgb = render_pixels(scene, camera, integrator, pixel_xy, spp=spp, max_depth=depth,
                            remat=remat)
        return rgb.reshape(h, w, 3)

    return render


def l2_loss_fn(render_fn, target):
    """Mean-squared-error loss against a target image."""

    def loss(params, base_arrays):
        img = render_fn(params, base_arrays)
        return torch.mean((img - target) ** 2)

    return loss
