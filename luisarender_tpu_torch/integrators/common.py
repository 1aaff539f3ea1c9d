"""The path-tracing bounce step.

Counterpart of luisarender_tpu/integrators/common.py (`init_carry`,
`has_work`, `shade_surface`, `bounce_step`) on the reference's default
branch: compute-all surface dispatch, the NEE shadow ray traced in the same
bounce (FUSE_SHADOW_TRACES=False). Under a spectrum that is not fixed, a
path that hits a dispersive surface keeps only its hero wavelength from
there on (SampledWavelengths.terminate_secondary). A ray that escapes adds
the environment's radiance with its MIS weight against the BSDF sample that
made it, and NEE picks the environment as the light sampler says. The carry
is a dict of per-path tensors; every path draws its 7 uniforms per bounce in
the reference's order whether or not it is still active, so the sampler
streams stay aligned with the reference's. Where the scene has an image
texture, the carry also holds the reference's ray cone (`cone_width`,
`cone_spread`): it widens by the spread times the hit distance at each
hit, and the interaction's footprint picks the image's level of detail.
"""

from __future__ import annotations

import torch

from ..accel import traverse
from ..core import sampling
from ..core import types as ct
from ..core.spectrum import safe_div
from ..scene.geometry import surface_interaction
from ..surfaces import base as surf_base


def init_carry(ray, beta, state, swl, cone=None):
    """Fresh path state for a batch of camera rays; cone: the camera's
    (width0, spread) (Camera.ray_cone) to carry, or None."""
    zero_f = torch.zeros_like(ray.origin[..., 0])
    carry = {
        "ray": ray,
        "beta": beta,
        "L": torch.zeros_like(beta),
        "active": zero_f < 1.0,
        "state": state,
        "pdf_bsdf": zero_f + 1e16,
        "eta_scale": zero_f + 1.0,
        "depth": torch.zeros_like(zero_f, dtype=torch.int32),
        "swl": swl,
        "n_rays": torch.zeros((), dtype=torch.int64, device=zero_f.device),
    }
    if cone is not None:
        carry["cone_width"] = zero_f + float(cone[0])
        carry["cone_spread"] = zero_f + float(cone[1])
    return carry


def has_work(carry) -> bool:
    """Loop condition: any live path. Reading it syncs with the device once
    per bounce."""
    return bool(carry["active"].any())


def shade_surface(compiled, light_sampler, it, wo, swl, L, ray, beta,
                  pdf_bsdf, eta_scale, active, n_rays, uniforms, defer_shadow=False,
                  detach_sampling=False):
    """NEE + BSDF sampling at surface hits. uniforms = (u_sel, u_light (2),
    u_lobe, u_bsdf (2)). Returns the updated
    (L, ray, beta, pdf_bsdf, eta_scale, active, n_rays, event); with
    defer_shadow=True the NEE shadow ray is not traced, and a dict {ray,
    contrib, pending} follows for the caller to trace it and add contrib
    where it is pending and not occluded. detach_sampling=True stops
    gradients at the light sample's pdf, wi, p and ng and at the BSDF
    sample's wi and pdf, as the reference's differentiable pass does
    (diff/render.py): gradients flow through BSDF values, textures and
    emission, not through the sampling decisions."""
    geom = compiled.trace_geometry()
    n = it.p.shape[0]
    c = compiled.plan.spectral_dim
    u_sel, u_light, u_lobe, u_bsdf = uniforms
    zeros = it.p.new_zeros((n,))

    do_nee = compiled.plan.num_lights > 0 or compiled.plan.has_environment
    if do_nee:
        ls = light_sampler.sample(compiled, it, u_sel, u_light, swl)
        if detach_sampling:
            ls = {**ls, **{k: ls[k].detach() for k in ("pdf", "wi", "p", "ng")}}
        f_eval = surf_base.dispatch(
            compiled, it, "evaluate", swl, wo, ls["wi"],
            init={"f": it.p.new_zeros((n, c)), "pdf": zeros},
        )
    init_sample = {
        "f": it.p.new_zeros((n, c)),
        "pdf": zeros,
        "wi": torch.tensor([0.0, 0.0, 1.0], device=it.p.device).expand(n, 3),
        "event": torch.zeros((n,), dtype=torch.int32, device=it.p.device),
        "eta": torch.ones_like(zeros),
    }
    s = surf_base.dispatch(compiled, it, "sample", swl, wo, u_lobe, u_bsdf,
                           init=init_sample)

    # --- NEE contribution, shadow ray traced now ---
    if do_nee:
        shadow_ray = ct.spawn_ray_to(it, ls["p"], ls["ng"])
        shadow_pending = active & (ls["pdf"] > 0)
        shadow_ray = shadow_ray._replace(
            t_max=torch.where(shadow_pending, shadow_ray.t_max, 0.0)
        )
        n_rays = n_rays + shadow_pending.sum()
        w_mis = safe_div(
            sampling.balance_heuristic(ls["pdf"], f_eval["pdf"]), ls["pdf"]
        )
        contrib = beta * f_eval["f"] * ls["L"] * w_mis[..., None]
        contrib = torch.where(shadow_pending[..., None], contrib, 0.0)
        if defer_shadow:
            shadow = {"ray": shadow_ray, "contrib": contrib, "pending": shadow_pending}
        else:
            occluded = traverse.trace_any(geom, shadow_ray)
            nee_ok = shadow_pending & ~occluded
            L = torch.where(nee_ok[..., None], L + contrib, L)
    elif defer_shadow:
        shadow = {"ray": ray._replace(t_max=torch.zeros_like(zeros)),
                  "contrib": it.p.new_zeros((n, c)), "pending": zeros > 1.0}

    # --- BSDF sampling result ---
    if detach_sampling:
        s = {**s, "wi": s["wi"].detach(), "pdf": s["pdf"].detach()}
    new_ray = ct.spawn_ray(it, s["wi"])
    act3 = active[..., None]
    ray = ct.Ray(
        origin=torch.where(act3, new_ray.origin, ray.origin),
        direction=torch.where(act3, new_ray.direction, ray.direction),
        t_min=torch.where(active, new_ray.t_min, ray.t_min),
        t_max=torch.where(active, new_ray.t_max, ray.t_max),
    )
    pdf_bsdf = torch.where(active, s["pdf"], pdf_bsdf)
    beta_new = beta * safe_div(s["f"], s["pdf"][..., None])
    beta_new = torch.where(torch.isfinite(beta_new), beta_new, 0.0)
    beta = torch.where(act3, beta_new, beta)
    eta = s["eta"]
    eta_scale_new = torch.where(
        s["event"] == surf_base.EVENT_ENTER,
        eta_scale * eta * eta,
        torch.where(
            s["event"] == surf_base.EVENT_EXIT,
            eta_scale / torch.clamp(eta * eta, min=1e-12),
            eta_scale,
        ),
    )
    eta_scale = torch.where(active, eta_scale_new, eta_scale)
    active = active & (s["pdf"] > 0) & (beta > 0).any(dim=-1)
    if defer_shadow:
        return L, ray, beta, pdf_bsdf, eta_scale, active, n_rays, s["event"], shadow
    return L, ray, beta, pdf_bsdf, eta_scale, active, n_rays, s["event"]


def bounce_step(compiled, sampler, light_sampler, carry, *,
                max_depth, rr_depth, rr_threshold, detach_sampling=False):
    """Advance every active path by one bounce; returns the new carry.
    Paths that end this bounce have active=False and their final L.
    detach_sampling: as for shade_surface."""
    geom = compiled.trace_geometry()
    ray = carry["ray"]
    beta = carry["beta"]
    L = carry["L"]
    active = carry["active"]
    state = carry["state"]
    pdf_bsdf = carry["pdf_bsdf"]
    eta_scale = carry["eta_scale"]
    depth = carry["depth"]
    swl = carry["swl"]

    n_rays = carry["n_rays"] + active.sum()
    wo = -ray.direction
    # dead lanes keep their last ray; t_max = 0 makes the trace skip them
    trace_ray = ray._replace(t_max=torch.where(active, ray.t_max, 0.0))
    hit = traverse.trace_closest(geom, trace_ray)
    cone_width = None
    if "cone_width" in carry:
        # the cone widens linearly with distance; a miss adds nothing
        cone_width = carry["cone_width"] + carry["cone_spread"] * torch.where(
            torch.isfinite(hit.t), hit.t, 0.0)
    it = surface_interaction(compiled.arrays, hit, ray, needs_uv=compiled.plan.needs_uv,
                             cone_width=cone_width)
    it = it._replace(valid=it.valid & active)

    # --- miss: the environment ---
    if compiled.plan.has_environment:
        env_eval = light_sampler.evaluate_miss(compiled, ray.direction, swl)
        mis_w = sampling.balance_heuristic(pdf_bsdf, env_eval["pdf"])
        contrib = beta * env_eval["L"] * mis_w[..., None]
        L = torch.where((active & ~it.valid)[..., None], L + contrib, L)
    active = active & it.valid

    # --- hit an emissive instance ---
    instances = compiled.arrays["instances"]
    if compiled.plan.num_lights > 0:
        has_light = instances["light_tag"][it.inst] >= 0
        le = light_sampler.evaluate_hit(compiled, it, ray.origin, swl)
        mis_w = sampling.balance_heuristic(pdf_bsdf, le["pdf"])
        contrib = beta * le["L"] * mis_w[..., None]
        L = torch.where((active & has_light)[..., None], L + contrib, L)

    # --- no surface -> the path ends ---
    active = active & (instances["surface_tag"][it.inst] >= 0)

    # --- dispersion: collapse to the hero wavelength ---
    if not compiled.spectrum.is_fixed and surf_base.any_dispersive(compiled):
        disp = surf_base.dispersive_mask(compiled, it) & active
        terminated = swl.terminate_secondary()
        swl = swl._replace(pdf=torch.where(disp[..., None], terminated.pdf, swl.pdf))

    # --- uniform draws, in the reference's order ---
    state, u_sel = sampler.generate_1d(state)
    state, u_light = sampler.generate_2d(state)
    state, u_lobe = sampler.generate_1d(state)
    state, u_bsdf = sampler.generate_2d(state)
    state, u_rr = sampler.generate_1d(state)

    L, ray, beta, pdf_bsdf, eta_scale, active, n_rays, _ = shade_surface(
        compiled, light_sampler, it, wo, swl, L, ray, beta, pdf_bsdf,
        eta_scale, active, n_rays, (u_sel, u_light, u_lobe, u_bsdf),
        detach_sampling=detach_sampling,
    )

    # --- Russian roulette ---
    q = torch.clamp(beta.amax(dim=-1) * eta_scale, min=0.05)
    do_rr = (depth + 1 >= rr_depth) & active
    below = do_rr & (q < rr_threshold)
    kill = below & (u_rr >= q)
    boost = torch.where(below, 1.0 / torch.clamp(q, min=1e-6), 1.0)
    beta = beta * boost[..., None]
    active = active & ~kill

    depth = depth + 1
    active = active & (depth < max_depth)
    out = {
        "ray": ray,
        "beta": beta,
        "L": L,
        "active": active,
        "state": state,
        "pdf_bsdf": pdf_bsdf,
        "eta_scale": eta_scale,
        "depth": depth,
        "swl": swl,
        "n_rays": n_rays,
    }
    if cone_width is not None:
        out["cone_width"] = torch.where(active, cone_width, carry["cone_width"])
        out["cone_spread"] = carry["cone_spread"]
    return out
