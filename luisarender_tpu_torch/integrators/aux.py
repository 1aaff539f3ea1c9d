"""Auxiliary integrators: normal visualizer, direct lighting, AOV, group.

Counterpart of luisarender_tpu/integrators/aux.py, its render loops
included (a sample at a time at shutter time 0, no checkpoint, no
preview):
- normal: the shading or geometric normal, remapped from [-1, 1] to
  [0, 1] unless `remap` is false;
- direct: one bounce of direct lighting, `importance_sampling` light,
  surface or both (MIS);
- aov: the legacy single-buffer mode (`variant`: one component into the
  camera's film) or the multi-buffer mode: every component of
  `components` (default all nine of COMPONENTS) accumulated over
  `noisy_count` samples and dumped by `dump` (power2: at each power of two
  samples, all: every sample, final: once) as
  `{stem}_{component}_{count:05}{ext}` (`{stem}_{component}{ext}` for
  final), each divided by its sample count;
- group: its child integrators, one after another.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..accel import traverse
from ..core import frame as fr
from ..core import sampling
from ..core import types as ct
from ..core.spectrum import safe_div
from ..scene.geometry import surface_interaction
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..surfaces import base as surf_base
from ..utils import imageio
from . import common
from .base import Integrator, ProgressiveIntegrator
from .mega_path import camera_rays, path_trace_batch, pixel_grid, wavelengths

log = logging.getLogger("luisarender_tpu_torch")


def _camera_rays(compiled, camera, sampler, pixel_xy, sample_index):
    """(camera ray, sampler state past the camera's and the wavelengths'
    draws, wavelengths, camera weight) at shutter time 0."""
    state, ray, weight = camera_rays(camera, sampler, pixel_xy, sample_index)
    state, swl = wavelengths(compiled.spectrum, sampler, state, pixel_xy)
    return ray, state, swl, weight


class _SimpleProgressive(ProgressiveIntegrator):
    """A sample at a time of `_sample_radiance` into the camera's film."""

    def _sample_radiance(self, compiled, camera, pixel_xy, sample_index):
        raise NotImplementedError

    def _render_one_camera(self, compiled, camera):
        w, h = camera.film.resolution
        film = camera.film
        pixel_xy = pixel_grid(w, h, compiled.device)
        accum = film.prepare(compiled.device)
        for sample_index in range(camera.spp):
            rgb, weight = self._sample_radiance(compiled, camera, pixel_xy, sample_index)
            accum = film.accumulate_image(accum, rgb.reshape(h, w, 3), weight.reshape(h, w))
        return film.develop(accum)


@register(SceneNodeTag.INTEGRATOR, "normal", "Normal")
class NormalVisualizer(_SimpleProgressive):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.shading = desc.string("normal", "shading").lower() != "geometric"
        self.remap = desc.bool("remap", True)

    def _sample_radiance(self, compiled, camera, pixel_xy, sample_index):
        ray, _, _, weight = _camera_rays(compiled, camera, self.sampler, pixel_xy,
                                         sample_index)
        hit = traverse.trace_closest(compiled.trace_geometry(), ray)
        it = surface_interaction(compiled.arrays, hit, ray)
        valid = it.valid[..., None]
        n = torch.where(valid, it.ns if self.shading else it.ng, 0.0)
        if self.remap:
            n = torch.where(valid, n * 0.5 + 0.5, 0.0)
        return n, weight


@register(SceneNodeTag.INTEGRATOR, "direct", "Direct")
class DirectLighting(_SimpleProgressive):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        mode = desc.string("importance_sampling", "both").lower()
        if mode not in ("light", "surface", "both"):
            raise ValueError(f"invalid importance_sampling '{mode}'")
        self.mode = mode

    def _sample_radiance(self, compiled, camera, pixel_xy, sample_index):
        sampler, light_sampler = self.sampler, self.light_sampler
        geom = compiled.trace_geometry()
        plan = compiled.plan
        instances = compiled.arrays["instances"]
        n, c = pixel_xy.shape[0], plan.spectral_dim

        ray, state, swl, cam_weight = _camera_rays(compiled, camera, sampler, pixel_xy,
                                                   sample_index)
        wo = -ray.direction
        hit = traverse.trace_closest(geom, ray)
        it = surface_interaction(compiled.arrays, hit, ray)
        zeros = torch.zeros_like(ray.t_min)
        L = zeros.new_zeros((n, c))
        beta = cam_weight[..., None].expand(n, c)
        if plan.has_environment:
            env = light_sampler.evaluate_miss(compiled, ray.direction, swl)
            L = torch.where((~it.valid)[..., None], L + beta * env["L"], L)
        if plan.num_lights > 0:
            has_light = instances["light_tag"][it.inst] >= 0
            le = light_sampler.evaluate_hit(compiled, it, ray.origin, swl)
            L = torch.where((it.valid & has_light)[..., None], L + beta * le["L"], L)
        has_surface = (instances["surface_tag"][it.inst] >= 0) & it.valid
        it = it._replace(valid=has_surface)

        state, u_sel = sampler.generate_1d(state)
        state, u_light = sampler.generate_2d(state)
        state, u_lobe = sampler.generate_1d(state)
        state, u_bsdf = sampler.generate_2d(state)
        lit = plan.num_lights > 0 or plan.has_environment

        if self.mode in ("light", "both") and lit:
            ls = light_sampler.sample(compiled, it, u_sel, u_light, swl)
            sray = ct.spawn_ray_to(it, ls["p"], ls["ng"])
            sray = sray._replace(
                t_max=torch.where(has_surface & (ls["pdf"] > 0), sray.t_max, 0.0))
            occ = traverse.trace_any(geom, sray)
            f_eval = surf_base.dispatch(compiled, it, "evaluate", swl, wo, ls["wi"],
                                        init={"f": zeros.new_zeros((n, c)), "pdf": zeros})
            w = safe_div(torch.ones_like(ls["pdf"]), ls["pdf"])
            if self.mode == "both":
                w = w * sampling.balance_heuristic(ls["pdf"], f_eval["pdf"])
            ok = has_surface & (ls["pdf"] > 0) & ~occ
            L = torch.where(ok[..., None], L + beta * f_eval["f"] * ls["L"] * w[..., None], L)

        if self.mode in ("surface", "both") and lit:
            s = surf_base.dispatch(compiled, it, "sample", swl, wo, u_lobe, u_bsdf, init={
                "f": zeros.new_zeros((n, c)), "pdf": zeros,
                "wi": torch.tensor([0.0, 0.0, 1.0], device=zeros.device).expand(n, 3),
                "event": torch.zeros((n,), dtype=torch.int32, device=zeros.device),
                "eta": zeros + 1.0})
            ray2 = ct.spawn_ray(it, s["wi"])
            ray2 = ray2._replace(
                t_max=torch.where(has_surface & (s["pdf"] > 0), ray2.t_max, 0.0))
            it2 = surface_interaction(compiled.arrays, traverse.trace_closest(geom, ray2), ray2)
            tp = beta * safe_div(s["f"], s["pdf"][..., None])
            sampled = has_surface & (s["pdf"] > 0)
            if plan.num_lights > 0:
                has_light2 = (instances["light_tag"][it2.inst] >= 0) & it2.valid
                le2 = light_sampler.evaluate_hit(compiled, it2, ray2.origin, swl)
                w2 = (sampling.balance_heuristic(s["pdf"], le2["pdf"])
                      if self.mode == "both" else torch.ones_like(s["pdf"]))
                L = torch.where((sampled & has_light2)[..., None],
                                L + tp * le2["L"] * w2[..., None], L)
            if plan.has_environment:
                env2 = light_sampler.evaluate_miss(compiled, ray2.direction, swl)
                w2 = (sampling.balance_heuristic(s["pdf"], env2["pdf"])
                      if self.mode == "both" else torch.ones_like(s["pdf"]))
                L = torch.where((sampled & ~it2.valid)[..., None],
                                L + tp * env2["L"] * w2[..., None], L)
        return compiled.spectrum.srgb(L, swl), torch.ones((n,), device=zeros.device)


@register(SceneNodeTag.INTEGRATOR, "aov", "AOV")
class AOVIntegrator(_SimpleProgressive):
    """Auxiliary buffers. With `variant`, that one component lands in the
    camera's film (its clamp lifted: the buffers are data, not radiance);
    otherwise the multi-buffer mode renders every component of
    `components` over `noisy_count` samples and dumps them by `dump`
    (power2, all or final). `noisy_count` below 8 is kept, as the
    reference keeps it."""

    VARIANTS = ("sample", "normal", "albedo", "depth", "roughness", "mask")
    # component -> channels
    COMPONENTS = {
        "sample": 3, "diffuse": 3, "specular": 3, "normal": 3, "albedo": 3,
        "depth": 1, "roughness": 2, "ndc": 3, "mask": 1,
    }

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.variant = desc.string("variant", "").lower()
        if self.variant and self.variant not in self.VARIANTS:
            raise ValueError(f"unknown AOV variant '{self.variant}'; choose {self.VARIANTS}")
        self.max_depth = desc.int("depth", 10)
        self.rr_depth = desc.int("rr_depth", 0)
        self.rr_threshold = desc.float("rr_threshold", 0.95)
        self.noisy_count = max(desc.int("noisy_count", 8), 1)
        enabled = set()
        for comp in desc.string_list("components", ["all"]):
            comp = comp.lower()
            if comp == "all":
                enabled |= set(self.COMPONENTS)
            elif comp in self.COMPONENTS:
                enabled.add(comp)
            else:
                log.warning("ignoring unknown AOV component '%s'", comp)
        self.components = sorted(enabled)
        dump = desc.string("dump", "power2").lower()
        if dump not in ("power2", "all", "final"):
            log.warning("unknown dump strategy '%s'; falling back to power2", dump)
            dump = "power2"
        self.dump_strategy = dump

    # --- the multi-buffer mode ---

    def _should_dump(self, n):
        if self.dump_strategy == "power2":
            return n > 0 and (n & (n - 1)) == 0
        if self.dump_strategy == "all":
            return True
        return n == self.noisy_count

    def _aov_sample(self, compiled, camera, pixel_xy, sample_index):
        """One sample of every enabled component: {component: (N, channels)}.
        The path is NEE + MIS path tracing with a second, diffuse-only
        accumulator that pauses across specular bounces (every lobe's
        roughness under 0.05)."""
        sampler, light_sampler = self.sampler, self.light_sampler
        geom = compiled.trace_geometry()
        plan = compiled.plan
        instances = compiled.arrays["instances"]
        n, c = pixel_xy.shape[0], plan.spectral_dim
        want = set(self.components)
        ray, state, swl, cam_weight = _camera_rays(compiled, camera, sampler, pixel_xy,
                                                   sample_index)
        out = {}

        # --- first-hit components ---
        hit = traverse.trace_closest(geom, ray)
        it = surface_interaction(compiled.arrays, hit, ray)
        valid = it.valid
        v3 = valid[..., None]
        if "mask" in want:
            out["mask"] = valid.to(torch.float32)[..., None]
        if "normal" in want:
            out["normal"] = torch.where(v3, it.ns, 0.0)
        first_depth = torch.where(valid, fr.length(it.p - ray.origin), 0.0)
        if "depth" in want:
            out["depth"] = first_depth[..., None]
        if "ndc" in want:
            w, h = camera.film.resolution
            res = torch.tensor([w, h], dtype=torch.float32, device=ray.t_min.device)
            flip = torch.tensor([1.0, -1.0], device=ray.t_min.device)
            ndc_xy = ((pixel_xy.to(torch.float32) + 0.5) / res * 2.0 - 1.0) * flip
            ndc_z = first_depth / torch.clamp(ray.t_max - ray.t_min, min=1e-6)
            out["ndc"] = torch.where(v3, torch.cat([ndc_xy, ndc_z[..., None]], dim=-1), 0.0)
        if "albedo" in want:
            a = surf_base.dispatch(compiled, it, "albedo", swl,
                                   init=ray.t_min.new_zeros((n, c)))
            out["albedo"] = torch.where(v3, compiled.spectrum.srgb(a, swl), 0.0)
        if "roughness" in want:
            r = surf_base.dispatch(compiled, it, "roughness",
                                   init=ray.t_min.new_ones((n, 2)))
            out["roughness"] = torch.where(v3, r, 0.0)
        if not want & {"sample", "diffuse", "specular"}:
            return out

        # --- the path, with the diffuse accumulator beside it ---
        zeros = torch.zeros_like(ray.t_min)
        beta = cam_weight[..., None].expand(n, c)
        beta_d = beta
        L = zeros.new_zeros((n, c))
        L_d = zeros.new_zeros((n, c))
        active = zeros < 1.0
        pdf_bsdf = zeros + 1e16
        eta_scale = zeros + 1.0
        spec = zeros > 1.0  # the last bounce was specular
        depth = 0
        while depth < self.max_depth and bool(active.any()):
            wo = -ray.direction
            hit_b = hit if depth == 0 else traverse.trace_closest(
                geom, ray._replace(t_max=torch.where(active, ray.t_max, 0.0)))
            it_b = surface_interaction(compiled.arrays, hit_b, ray)
            it_b = it_b._replace(valid=it_b.valid & active)

            def add(L, L_d, x, mask):
                # L += beta x, and L_d += beta_d x off specular bounces
                L = torch.where(mask[..., None], L + beta * x, L)
                L_d = torch.where((mask & ~spec)[..., None], L_d + beta_d * x, L_d)
                return L, L_d

            if plan.has_environment:
                env = light_sampler.evaluate_miss(compiled, ray.direction, swl)
                mw = sampling.balance_heuristic(pdf_bsdf, env["pdf"])
                L, L_d = add(L, L_d, env["L"] * mw[..., None], active & ~it_b.valid)
            active2 = active & it_b.valid
            if plan.num_lights > 0:
                has_light = instances["light_tag"][it_b.inst] >= 0
                le = light_sampler.evaluate_hit(compiled, it_b, ray.origin, swl)
                mw = sampling.balance_heuristic(pdf_bsdf, le["pdf"])
                L, L_d = add(L, L_d, le["L"] * mw[..., None], active2 & has_light)
            active2 = active2 & (instances["surface_tag"][it_b.inst] >= 0)
            it_b = it_b._replace(valid=active2)

            state, u_sel = sampler.generate_1d(state)
            state, u_light = sampler.generate_2d(state)
            state, u_lobe = sampler.generate_1d(state)
            state, u_bsdf = sampler.generate_2d(state)
            state, u_rr = sampler.generate_1d(state)

            L, ray, beta2, pdf_bsdf, eta_scale, active3, _, _, shadow = common.shade_surface(
                compiled, light_sampler, it_b, wo, swl, L, ray, beta, pdf_bsdf, eta_scale,
                active2, zeros.new_zeros((), dtype=torch.int64), (u_sel, u_light, u_lobe, u_bsdf),
                defer_shadow=True)
            nee_ok = shadow["pending"] & ~traverse.trace_any(geom, shadow["ray"])
            L = torch.where(nee_ok[..., None], L + shadow["contrib"], L)
            L_d = torch.where((nee_ok & ~spec)[..., None],
                              L_d + shadow["contrib"] * safe_div(beta_d, beta), L_d)
            # the diffuse throughput follows beta's update off specular bounces
            beta_d = torch.where((active2 & ~spec)[..., None],
                                 beta_d * safe_div(beta2, beta), beta_d)
            rough = surf_base.dispatch(compiled, it_b, "roughness",
                                       init=zeros.new_ones((n, 2)))
            spec = torch.where(active2, (rough < 0.05).all(dim=-1), spec)

            q = torch.clamp(beta2.amax(dim=-1) * eta_scale, min=0.05)
            do_rr = (depth + 1 >= self.rr_depth) & active3
            below = do_rr & (q < self.rr_threshold)
            kill = below & (u_rr >= q)
            boost = torch.where(below, 1.0 / torch.clamp(q, min=1e-6), 1.0)[..., None]
            beta = beta2 * boost
            beta_d = beta_d * boost
            active = active3 & ~kill
            depth += 1

        rgb = compiled.spectrum.srgb(L, swl)
        rgb_d = compiled.spectrum.srgb(L_d, swl)
        if "sample" in want:
            out["sample"] = rgb
        if "diffuse" in want:
            out["diffuse"] = rgb_d
        if "specular" in want:
            out["specular"] = rgb - rgb_d
        return out

    def _render_aovs(self, compiled, camera, save):
        """The components' buffers over noisy_count samples, dumped by the
        strategy; returns {file: (H, W, channels) image}."""
        w, h = camera.film.resolution
        pixel_xy = pixel_grid(w, h, compiled.device)
        bufs = {comp: torch.zeros((h * w, self.COMPONENTS[comp]), dtype=torch.float32,
                                  device=compiled.device) for comp in self.components}
        stem, ext = os.path.splitext(camera.file)
        ext = ext or ".exr"
        results = {}
        for s in range(self.noisy_count):
            vals = self._aov_sample(compiled, camera, pixel_xy, s)
            bufs = {k: bufs[k] + torch.nan_to_num(v) for k, v in vals.items()}
            count = s + 1
            if not self._should_dump(count):
                continue
            for comp in self.components:
                img = (bufs[comp] * (1.0 / count)).reshape(h, w, -1).cpu().numpy()
                if self.dump_strategy == "final":
                    path = f"{stem}_{comp}{ext}"
                else:
                    path = f"{stem}_{comp}_{count:05d}{ext}"
                results[path] = np.asarray(img)
                if save:
                    imageio.save_image(path, results[path])
        return results

    def render(self, compiled, save: bool = False) -> dict:
        if self.variant:
            return super().render(compiled, save=save)
        results = {}
        for camera in compiled.scene.cameras:
            results.update(self._render_aovs(compiled, camera, save))
        return results

    # --- the single-buffer mode (`variant`) ---

    def _render_one_camera(self, compiled, camera):
        saved_clamp = camera.film.clamp
        camera.film.clamp = 1e30
        try:
            return super()._render_one_camera(compiled, camera)
        finally:
            camera.film.clamp = saved_clamp

    def _sample_radiance(self, compiled, camera, pixel_xy, sample_index):
        if self.variant == "sample":
            return path_trace_batch(compiled, camera, self.sampler, self.light_sampler,
                                    pixel_xy, sample_index, max_depth=10, rr_depth=0,
                                    rr_threshold=0.95)
        n, c = pixel_xy.shape[0], compiled.plan.spectral_dim
        ray, _, swl, weight = _camera_rays(compiled, camera, self.sampler, pixel_xy,
                                           sample_index)
        hit = traverse.trace_closest(compiled.trace_geometry(), ray)
        it = surface_interaction(compiled.arrays, hit, ray)
        valid = it.valid[..., None]
        if self.variant == "normal":
            return torch.where(valid, it.ns * 0.5 + 0.5, 0.0), weight
        if self.variant in ("depth", "mask"):
            v = torch.where(it.valid, hit.t, 0.0) if self.variant == "depth" else (
                it.valid.to(torch.float32))
            return torch.stack([v, v, v], dim=-1), weight
        if self.variant == "roughness":
            r = surf_base.dispatch(compiled, it, "roughness", init=ray.t_min.new_ones((n, 2)))
            out = torch.cat([r, ray.t_min.new_zeros((n, 1))], dim=-1)
            return torch.where(valid, out, 0.0), weight
        a = surf_base.dispatch(compiled, it, "albedo", swl, init=ray.t_min.new_zeros((n, c)))
        return torch.where(valid, compiled.spectrum.srgb(a, swl), 0.0), weight


@register(SceneNodeTag.INTEGRATOR, "group", "Group")
class GroupIntegrator(Integrator):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.children = [scene.load_integrator(i) for i in desc.node_list("integrators")]
        if not self.children:
            raise ValueError("group integrator needs children")

    def render(self, compiled, save: bool = False) -> dict:
        results = {}
        for child in self.children:
            results.update(child.render(compiled, save=save))
        return results
