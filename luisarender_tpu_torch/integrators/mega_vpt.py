"""Volumetric path tracer ("megavpt"): homogeneous and grid media, nested
by priority.

Counterpart of luisarender_tpu/integrators/mega_vpt.py, its own render loop
included (a sample at a time at shutter time 0, no checkpoint, no
preview). Each path carries a medium tracker (core/medium_tracker.py),
started in the scene's environment medium. An iteration of the host loop
advances every path by one event:

  trace     the closest hit (dead lanes traced with t_max 0);
  medium    a distance sampled in the current medium over [0, t_hit]
            (media/base.py dispatch: a grid's tracking loops only on its
            own lanes), its weight into the throughput;
  scatter   NEE from the scattering point, its shadow ray from t_min 1e-3
            to (1 - 1e-3) of the light's distance, weighed by the
            transmittance through the current medium only (boundaries
            along the shadow ray are ignored, as in the reference) and the
            Henyey-Greenstein phase value, MIS against phase sampling;
            then a phase-sampled direction;
  null      a surface without a surface type crosses its medium boundary
            (the tracker entered or left by the side of the crossing); it
            uses no depth, at most MAX_NULL_CROSSINGS of them a path;
  surface   integrators/common.py shade_surface, and a transmissive
            event's crossing updates the tracker too.

The three continuations merge by event; scattering and surface events use
depth and Russian roulette. Every lane draws u_ch, u_dist, u_sel, u_light,
u_phase, u_lobe, u_bsdf and u_rr on every iteration, in the reference's
order. The loop reads its live flag to the host once an iteration.
"""

from __future__ import annotations

import torch

from ..accel import traverse
from ..core import frame as fr
from ..core import medium_tracker as mt
from ..core import rng
from ..core import sampling
from ..core import types as ct
from ..core.spectrum import safe_div
from ..media import base as med_base
from ..phasefunctions.hg import hg_p, hg_sample
from ..scene.geometry import surface_interaction
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..surfaces import base as surf_base
from . import common
from .base import ProgressiveIntegrator
from .mega_path import camera_rays, pixel_grid, wavelengths

MAX_NULL_CROSSINGS = 32


def _track_seed(state, depth):
    """The per-lane seed of a grid's tracking loops: the sampler state's word
    (the independent sampler's) or, for a dict state (the low-discrepancy
    samplers'), xxhash32(pixel, sample); hashed with the path depth."""
    src = rng.xxhash32(state["pixel"], state["sample"]) if isinstance(state, dict) else state
    return rng.xxhash32(src, depth, 0x7272)


def _merge(scattered, is_null, shade_active, scatter_v, null_v, shade_v, old_v):
    def b(m):
        return m.reshape(m.shape + (1,) * (scatter_v.dim() - 1))

    return torch.where(b(scattered), scatter_v, torch.where(
        b(is_null), null_v, torch.where(b(shade_active), shade_v, old_v)))


def vpt_step(compiled, sampler, light_sampler, carry, *, max_depth, rr_depth, rr_threshold):
    """Advance every active path by one event; returns the new carry."""
    geom = compiled.trace_geometry()
    plan = compiled.plan
    instances = compiled.arrays["instances"]
    ray, beta, L = carry["ray"], carry["beta"], carry["L"]
    active, state, swl = carry["active"], carry["state"], carry["swl"]
    pdf_bsdf, eta_scale, depth = carry["pdf_bsdf"], carry["eta_scale"], carry["depth"]
    tracker, crossings = carry["tracker"], carry["crossings"]
    n = ray.origin.shape[0]
    c = plan.spectral_dim
    n_rays = carry["n_rays"] + active.sum()

    wo = -ray.direction
    hit = traverse.trace_closest(geom, ray._replace(t_max=torch.where(active, ray.t_max, 0.0)))
    it = surface_interaction(compiled.arrays, hit, ray)
    it = it._replace(valid=it.valid & active)
    t_hit = torch.where(torch.isfinite(hit.t), hit.t, 1e8)

    # --- a distance in the current medium over [0, t_hit] ---
    in_medium, cur_ref = mt.current(tracker)
    cur_tag, cur_idx = mt.unpack_ref(cur_ref)
    cur_tag = torch.where(in_medium, cur_tag, -1)
    state, u_ch = sampler.generate_1d(state)
    state, u_dist = sampler.generate_1d(state)
    track_seed = _track_seed(state, depth)
    zeros = torch.zeros_like(t_hit)
    if plan.has_media:
        medium_lanes = active & in_medium
        ms = med_base.dispatch(
            compiled, cur_tag, cur_idx, "sample_distance", swl, t_hit, u_ch, u_dist,
            ray.origin, ray.direction, track_seed,
            init={"t": t_hit, "scattered": zeros > 1.0, "weight": beta.new_ones((n, c)),
                  "g": zeros},
            lanes=medium_lanes)
        scattered = ms["scattered"] & medium_lanes
        beta = torch.where(medium_lanes[..., None], beta * ms["weight"], beta)
    else:
        scattered = zeros > 1.0
        ms = {"t": t_hit, "g": zeros}

    state, u_sel = sampler.generate_1d(state)
    state, u_light = sampler.generate_2d(state)
    state, u_phase = sampler.generate_2d(state)
    state, u_lobe = sampler.generate_1d(state)
    state, u_bsdf = sampler.generate_2d(state)
    state, u_rr = sampler.generate_1d(state)

    # --- scattering: NEE through the current medium, then the phase ---
    p_scatter = ray.origin + ms["t"][..., None] * ray.direction
    if plan.has_media and (plan.num_lights > 0 or plan.has_environment):
        it_med = ct.Interaction(
            valid=scattered, inst=torch.zeros_like(cur_tag), prim=torch.zeros_like(cur_tag),
            p=p_scatter, ng=wo, ns=wo, tangent=fr.make_frame(wo)["s"],
            uv=zeros.new_zeros((n, 2)), prim_area=zeros + 1.0, back_facing=zeros > 1.0)
        ls = light_sampler.sample(compiled, it_med, u_sel, u_light, swl)
        d_light = fr.length(ls["p"] - p_scatter)
        shadow_ray = ct.make_ray(p_scatter, ls["wi"], t_min=1e-3, t_max=d_light * (1 - 1e-3))
        shadow_ray = shadow_ray._replace(
            t_max=torch.where(scattered & (ls["pdf"] > 0), shadow_ray.t_max, 0.0))
        occluded = traverse.trace_any(geom, shadow_ray)
        nee_ok = scattered & (ls["pdf"] > 0) & ~occluded
        # the transmittance only where it is used
        tr = med_base.dispatch(
            compiled, cur_tag, cur_idx, "transmittance", swl, d_light, p_scatter, ls["wi"],
            rng.xxhash32(track_seed, 0x5AD0), init=beta.new_ones((n, c)), lanes=nee_ok)
        phase_val = hg_p(fr.dot(wo, ls["wi"]), ms["g"])
        w_mis = safe_div(sampling.balance_heuristic(ls["pdf"], phase_val), ls["pdf"])
        contrib = beta * tr * ls["L"] * (phase_val * w_mis)[..., None]
        L = torch.where(nee_ok[..., None], L + contrib, L)
    wi_phase, phase_pdf = hg_sample(wo, u_phase, ms["g"])
    scatter_ray = ct.make_ray(p_scatter, wi_phase, t_min=1e-3)

    # --- null surfaces: cross the medium boundary ---
    surf_active = active & ~scattered & it.valid
    is_null = (instances["surface_tag"][it.inst] < 0) & surf_active
    inst_m_tag = instances["medium_tag"][it.inst]
    inst_m_prio = instances["medium_priority"][it.inst]
    has_inst_medium = inst_m_tag >= 0
    entering = fr.dot(ray.direction, it.ng) < 0.0
    m_ref = mt.pack_ref(inst_m_tag, instances["medium_index"][it.inst])
    tracker = mt.enter(tracker, is_null & has_inst_medium & entering, m_ref, inst_m_prio)
    tracker = mt.exit_(tracker, is_null & has_inst_medium & ~entering, m_ref)
    null_ray = ct.spawn_ray(it, ray.direction)
    crossings = crossings + is_null.to(torch.int32)

    # --- real surfaces ---
    shade_active = surf_active & ~is_null
    if plan.has_environment:
        env_eval = light_sampler.evaluate_miss(compiled, ray.direction, swl)
        mis_w = sampling.balance_heuristic(pdf_bsdf, env_eval["pdf"])
        miss_now = active & ~scattered & ~it.valid
        L = torch.where(miss_now[..., None], L + beta * env_eval["L"] * mis_w[..., None], L)
    if plan.num_lights > 0:
        has_light = instances["light_tag"][it.inst] >= 0
        le = light_sampler.evaluate_hit(compiled, it, ray.origin, swl)
        mis_w = sampling.balance_heuristic(pdf_bsdf, le["pdf"])
        L = torch.where((shade_active & has_light)[..., None],
                        L + beta * le["L"] * mis_w[..., None], L)
    L, sray, beta_s, pdf_s, eta_scale_s, shade_ok, n_rays, event = common.shade_surface(
        compiled, light_sampler, it._replace(valid=shade_active), wo, swl, L, ray, beta,
        pdf_bsdf, eta_scale, shade_active, n_rays, (u_sel, u_light, u_lobe, u_bsdf))
    # a transmissive event crosses the surface's medium boundary too
    crossed_in = shade_active & (event == surf_base.EVENT_ENTER)
    crossed_out = shade_active & (event == surf_base.EVENT_EXIT)
    tracker = mt.enter(tracker, crossed_in & has_inst_medium, m_ref, inst_m_prio)
    tracker = mt.exit_(tracker, crossed_out & has_inst_medium, m_ref)

    # --- merge the three continuations ---
    def merge(scatter_v, null_v, shade_v, old_v):
        return _merge(scattered, is_null, shade_active, scatter_v, null_v, shade_v, old_v)

    ray = ct.Ray(*(merge(a, b, s, o) for a, b, s, o in zip(scatter_ray, null_ray, sray, ray)))
    beta = merge(beta, beta, beta_s, beta)
    pdf_bsdf = merge(phase_pdf, pdf_bsdf, pdf_s, pdf_bsdf)
    eta_scale = merge(eta_scale, eta_scale, eta_scale_s, eta_scale)

    # scattering and null crossings continue, shaded paths where shade_ok
    active = (scattered | (is_null & (crossings < MAX_NULL_CROSSINGS))
              | (shade_active & shade_ok))
    active = active & (beta > 0).any(dim=-1)
    # scattering and real surfaces use depth, null crossings do not
    consumed = scattered | shade_active
    depth = depth + consumed.to(torch.int32)
    q = torch.clamp(beta.amax(dim=-1) * eta_scale, min=0.05)
    do_rr = (depth >= rr_depth) & active & consumed
    below = do_rr & (q < rr_threshold)
    kill = below & (u_rr >= q)
    beta = beta * torch.where(below, 1.0 / torch.clamp(q, min=1e-6), 1.0)[..., None]
    active = active & ~kill & (depth < max_depth)
    return {"ray": ray, "beta": beta, "L": L, "active": active, "state": state,
            "pdf_bsdf": pdf_bsdf, "eta_scale": eta_scale, "depth": depth, "swl": swl,
            "n_rays": n_rays, "tracker": tracker, "crossings": crossings}


def vpt_trace_batch(compiled, camera, sampler, light_sampler, pixel_xy, sample_index, *,
                    max_depth, rr_depth, rr_threshold):
    """One sample of each pixel of pixel_xy (N, 2) int32 at shutter time 0.
    Returns (rgb (N, 3), filter weight (N,) of ones, stats) with stats
    'rays' (closest and surface-NEE rays, a device tensor), 'iterations'
    and 'host_reads' (the loop's live flag and the grid's reads)."""
    spectrum = compiled.spectrum
    plan = compiled.plan
    n = pixel_xy.shape[0]
    state, ray, cam_weight = camera_rays(camera, sampler, pixel_xy, sample_index)
    state, swl = wavelengths(spectrum, sampler, state, pixel_xy)
    tracker = mt.make_tracker((n,), device=pixel_xy.device)
    if plan.env_medium_ref is not None:
        tag, idx, prio = plan.env_medium_ref
        everywhere = torch.ones((n,), dtype=torch.bool, device=pixel_xy.device)
        tracker = mt.enter(tracker, everywhere,
                           torch.full((n,), (tag << 16) | idx, dtype=torch.int32,
                                      device=pixel_xy.device),
                           torch.full((n,), prio, dtype=torch.float32, device=pixel_xy.device))
    carry = common.init_carry(ray, cam_weight[..., None].expand(n, plan.spectral_dim), state,
                              swl)
    carry["tracker"] = tracker
    carry["crossings"] = torch.zeros((n,), dtype=torch.int32, device=pixel_xy.device)
    reads0 = med_base.host_reads
    iterations = 0
    while common.has_work(carry):
        carry = vpt_step(compiled, sampler, light_sampler, carry, max_depth=max_depth,
                         rr_depth=rr_depth, rr_threshold=rr_threshold)
        iterations += 1
    rgb = spectrum.srgb(carry["L"], carry["swl"])
    weight = torch.ones((n,), dtype=torch.float32, device=pixel_xy.device)
    return rgb, weight, {"rays": carry["n_rays"], "iterations": iterations,
                         "host_reads": iterations + 1 + med_base.host_reads - reads0}


@register(SceneNodeTag.INTEGRATOR, "megavpt", "MegaVPT", "megavptnaive", "MegaVPTNaive")
class MegakernelVolumePathTracing(ProgressiveIntegrator):
    """Defaults: depth 10, rr_depth 0, rr_threshold 0.95."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.max_depth = desc.int("depth", 10)
        self.rr_depth = desc.int("rr_depth", 0)
        self.rr_threshold = desc.float("rr_threshold", 0.95)
        # totals of the last render(): loop iterations and host reads
        self.iterations_run = 0
        self.host_reads = 0

    def render(self, compiled, save: bool = False) -> dict:
        self.iterations_run = self.host_reads = 0
        return super().render(compiled, save)

    def _render_one_camera(self, compiled, camera):
        w, h = camera.film.resolution
        film = camera.film
        pixel_xy = pixel_grid(w, h, compiled.device)
        accum = film.prepare(compiled.device)
        rays = torch.zeros((), dtype=torch.int64, device=compiled.device)
        for sample_index in range(camera.spp):
            rgb, weight, stats = vpt_trace_batch(
                compiled, camera, self.sampler, self.light_sampler, pixel_xy, sample_index,
                max_depth=self.max_depth, rr_depth=self.rr_depth,
                rr_threshold=self.rr_threshold)
            rays = rays + stats["rays"]
            self.iterations_run += stats["iterations"]
            self.bounces_run += stats["iterations"]
            self.host_reads += stats["host_reads"]
            accum = film.accumulate_image(accum, rgb.reshape(h, w, 3), weight.reshape(h, w))
        self._rays = self._rays + rays
        return film.develop(accum)
