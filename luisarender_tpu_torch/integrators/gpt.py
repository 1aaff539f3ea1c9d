"""Gradient-domain path tracing (GPT).

Counterpart of luisarender_tpu/integrators/gpt.py (Kettunen et al. 2015's
shift mapping). Each pixel traces a main path and four shifted paths, to
its right, bottom, left and top neighbours, which reuse every random number
of the main path. The shifted paths live on a shift-major (4N,) lane axis
beside the main path's (N,), and follow it through three connection
states:

  NOT_CONNECTED       the shifted path has its own vertices. Where the main
                      path's vertex, its next vertex and the shifted vertex
                      are all diffuse (mean roughness above
                      shift_threshold) it reconnects to the main path's next
                      vertex, with the geometric Jacobian; elsewhere it
                      copies the tangent-space half vector, reflective or
                      transmissive (the generalized half vector scaled by
                      the closures' etas);
  RECENTLY_CONNECTED  one more BSDF evaluation at the main vertex;
  CONNECTED           the main path's samples exactly.

Contributions carry the path-pdf-ratio MIS weights of the reference; a
failed shift falls back to the main path's own MIS radiance and gives its
offset nothing. The shifted pixels x = -1, x = w, y = -1 and y = h lie off
the film: their camera rays are made like any other, and the film's splats
drop them (a rolled image's border row or column is zeroed).

The render accumulates the primal image (the central pixel's emission 8x
and MIS radiance 2x at a weight of 4, each neighbour's splat 2x at a weight
of 1), the gradient buffers gradient_x / gradient_y (right and bottom
gradients at the pixel, left and top at the neighbour) and the share of
live shifts (effective), and, with `reconstruct` (the default), solves the
screened Poisson equation (alpha^2 I + grad^T grad) x = alpha^2 primal +
grad^T g by 60 conjugate-gradient steps. The aux buffers are returned and
saved as `{stem}_{key}{ext}` beside the camera's file. central_radiance
renders the plain path-traced estimate and no buffers.

Each iteration of the bounce loop reads its live flag to the host once.
"""

from __future__ import annotations

import os

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
from .base import ProgressiveIntegrator
from .mega_path import pixel_grid, wavelengths

D_EPS = 1e-8

NOT_CONNECTED = 0
RECENTLY_CONNECTED = 1
CONNECTED = 2

# the shifts' pixel offsets: right, bottom, left, top
PIXEL_SHIFTS = ((1, 0), (0, 1), (-1, 0), (0, -1))


def _tile4(x):
    """A main-path tensor (N, ...), or a NamedTuple of them, tiled onto the
    shift-major (4N, ...) axis."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_tile4(v) for v in x))
    return x.repeat((4,) + (1,) * (x.dim() - 1))


def _sel(mask, new, old):
    """new where mask, else old; the (L,) mask broadcast over trailing dims,
    and over each field of a NamedTuple."""
    if isinstance(new, tuple):
        return type(new)(*(None if a is None else _sel(mask, a, b)
                           for a, b in zip(new, old)))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())), new, old)


def _sum4(x):
    """(4N, ...) -> (N, ...): the four shifts' values summed in order."""
    x = x.reshape((4, -1) + tuple(x.shape[1:]))
    return x[0] + x[1] + x[2] + x[3]


def _sq(v):
    return fr.dot(v, v)


def _eval_surface(compiled, it, swl, wo, wi):
    n = it.p.shape[0]
    return surf_base.dispatch(
        compiled, it, "evaluate", swl, wo, wi,
        init={"f": it.p.new_zeros((n, swl.dimension)), "pdf": it.p.new_zeros((n,))})


def _vertex_diffuse(compiled, it, threshold):
    """Whether the vertex classifies as diffuse (reconnectable): its
    surface's mean roughness above the shift threshold; no surface reads 0."""
    rough = surf_base.dispatch(compiled, it, "roughness",
                               init=it.p.new_zeros(it.p.shape[:-1] + (2,)))
    return (rough[..., 0] + rough[..., 1]) / 2.0 > threshold


def _shading_frame(it):
    return fr.frame_from_z_and_hint(it.ns, it.tangent)


def _emitter_at(compiled, light_sampler, it, ray, swl):
    """(L, light pdf, hit an emitter) of a path ray arriving at `it`: a
    light's radiance where it hits one, the environment's where it escapes
    (with an environment)."""
    plan = compiled.plan
    n = it.p.shape[0]
    L = it.p.new_zeros((n, swl.dimension))
    pdf = it.p.new_zeros((n,))
    hit_emitter = torch.zeros((n,), dtype=torch.bool, device=it.p.device)
    if plan.num_lights > 0:
        has_light = (compiled.arrays["instances"]["light_tag"][it.inst] >= 0) & it.valid
        le = light_sampler.evaluate_hit(compiled, it, ray.origin, swl)
        L = torch.where(has_light[..., None], le["L"], L)
        pdf = torch.where(has_light, le["pdf"], pdf)
        hit_emitter = hit_emitter | has_light
    if plan.has_environment:
        miss = ~it.valid
        ev = light_sampler.evaluate_miss(compiled, ray.direction, swl)
        L = torch.where(miss[..., None], ev["L"], L)
        pdf = torch.where(miss, ev["pdf"], pdf)
        hit_emitter = hit_emitter | miss
    return L, pdf, hit_emitter


def shifted_pixels(pixel_xy):
    """(4N, 2) int32: each pixel moved by each of PIXEL_SHIFTS, shift-major."""
    offs = torch.tensor(PIXEL_SHIFTS, dtype=torch.int32, device=pixel_xy.device)
    return _tile4(pixel_xy) + offs.repeat_interleave(pixel_xy.shape[0], dim=0)


def gpt_trace_batch(compiled, camera, sampler, light_sampler, pixel_xy, sample_index, *,
                    max_depth, rr_depth, rr_threshold, shift_threshold, central=False,
                    time=0.0, stats=None):
    """One GPT sample of each pixel of pixel_xy (N, 2) int32, the camera
    posed at shutter time `time`. Returns a dict: very_direct (N, 3) (the
    first hit's emission), radiance (N, 3) (the main path's MIS radiance),
    neighbor (4N, 3) (the shifted paths' radiance), gradient (4N, 3),
    shift_alive (4N,) bool and the filter weight (N,). `stats`, a dict,
    gets 'iterations' (bounce-loop iterations) added."""
    spectrum = compiled.spectrum
    geom = compiled.trace_geometry()
    plan = compiled.plan
    instances = compiled.arrays["instances"]
    dev = pixel_xy.device
    n = pixel_xy.shape[0]
    c = plan.spectral_dim
    ls_on = plan.num_lights > 0 or plan.has_environment

    state = sampler.start(pixel_xy, sample_index)
    state, u_filter = sampler.generate_pixel_2d(state)
    if camera.requires_lens_sampling:
        state, u_lens = sampler.generate_2d(state)
    else:
        u_lens = torch.full((n, 2), 0.5, dtype=torch.float32, device=dev)
    state, swl = wavelengths(spectrum, sampler, state, pixel_xy)
    swl4 = _tile4(swl)

    # the main and the four shifted camera rays share u_filter and u_lens
    m_ray, _, m_cam_w = camera.generate_rays(pixel_xy, u_filter, u_lens, time)
    s_ray, _, s_cam_w = camera.generate_rays(shifted_pixels(pixel_xy), _tile4(u_filter),
                                             _tile4(u_lens), time)
    m_it = surface_interaction(compiled.arrays, traverse.trace_closest(geom, m_ray), m_ray,
                               needs_uv=plan.needs_uv)
    s_it = surface_interaction(compiled.arrays, traverse.trace_closest(geom, s_ray), s_ray,
                               needs_uv=plan.needs_uv)

    # very direct: the first hit's emission (or the environment's)
    vd_L, _, _ = _emitter_at(compiled, light_sampler, m_it, m_ray, swl)
    very_direct = vd_L * m_cam_w[..., None]

    m_weight = m_cam_w[..., None].expand(n, c).to(torch.float32)
    m_radiance = torch.zeros((n, c), dtype=torch.float32, device=dev)
    m_alive = m_it.valid & (instances["surface_tag"][m_it.inst] >= 0)
    s_weight = s_cam_w[..., None].expand(4 * n, c).to(torch.float32)
    s_pdf_div = torch.ones((4 * n,), dtype=torch.float32, device=dev)
    s_radiance = torch.zeros((4 * n, c), dtype=torch.float32, device=dev)
    s_gradient = torch.zeros((4 * n, c), dtype=torch.float32, device=dev)
    s_alive = s_it.valid
    s_status = torch.full((4 * n,), NOT_CONNECTED, dtype=torch.int32, device=dev)

    depth = 0
    while depth < max_depth and bool(m_alive.any()):
        last_segment = depth + 1 >= max_depth
        wo = -m_ray.direction
        m_diffuse = _vertex_diffuse(compiled, m_it, shift_threshold)
        s_diffuse = _vertex_diffuse(compiled, s_it, shift_threshold)

        # ================= NEE =================
        state, u_sel = sampler.generate_1d(state)
        state, u_light = sampler.generate_2d(state)
        if ls_on:
            ls = light_sampler.sample(compiled, m_it, u_sel, u_light, swl)
            m_shadow = ct.spawn_ray_to(m_it, ls["p"], ls["ng"])
            m_shadow = m_shadow._replace(
                t_max=torch.where(m_alive & (ls["pdf"] > 0), m_shadow.t_max, 0.0))
            m_occ = traverse.trace_any(geom, m_shadow)
            nee_valid = m_alive & (ls["pdf"] > 0) & ~m_occ
            m_f = _eval_surface(compiled, m_it, swl, wo, ls["wi"])
            m_d2 = _sq(m_it.p - ls["p"])
            m_cos = fr.dot(ls["ng"], fr.normalize(m_it.p - ls["p"]))
            t_nee = _tile4(nee_valid)
            t_ls_pdf, t_f_pdf = _tile4(ls["pdf"]), _tile4(m_f["pdf"])
            t_fL = _tile4(m_f["f"] * ls["L"])
            t_weight = _tile4(m_weight)
            t_it = _tile4(m_it)

            # a failed shift: the main path's own MIS
            mc = t_fL * t_weight / torch.clamp(t_ls_pdf + t_f_pdf, min=D_EPS)[..., None]
            sc = torch.zeros_like(mc)
            ok = torch.zeros((4 * n,), dtype=torch.bool, device=dev)

            # CONNECTED: the main sample exactly
            denom_c = t_ls_pdf + t_f_pdf + s_pdf_div * (t_f_pdf + t_ls_pdf)
            is_c = s_alive & (s_status == CONNECTED)
            dc = torch.clamp(denom_c, min=D_EPS)[..., None]
            mc = _sel(is_c, t_fL * t_weight / dc, mc)
            sc = _sel(is_c, t_fL * s_weight * s_pdf_div[..., None] / dc, sc)
            ok = ok | is_c

            # RECENTLY_CONNECTED: evaluated at the main vertex with the
            # shifted wo
            inc = fr.normalize(s_it.p - t_it.p)
            r_eval = _eval_surface(compiled, t_it, swl4, inc, _tile4(ls["wi"]))
            denom_r = t_ls_pdf + t_f_pdf + s_pdf_div * (r_eval["pdf"] + t_ls_pdf)
            is_r = s_alive & (s_status == RECENTLY_CONNECTED)
            dr = torch.clamp(denom_r, min=D_EPS)[..., None]
            mc = _sel(is_r, t_fL * t_weight / dr, mc)
            sc = _sel(is_r, r_eval["f"] * _tile4(ls["L"]) * s_weight * s_pdf_div[..., None] / dr,
                      sc)
            ok = ok | is_r

            # NOT_CONNECTED, both vertices diffuse: the shifted vertex's own
            # NEE with the same numbers
            s_ls = light_sampler.sample(compiled, s_it, _tile4(u_sel), _tile4(u_light), swl4)
            is_n = s_alive & (s_status == NOT_CONNECTED) & _tile4(m_diffuse) & s_diffuse
            s_shadow = ct.spawn_ray_to(s_it, s_ls["p"], s_ls["ng"])
            s_shadow = s_shadow._replace(t_max=torch.where(
                is_n & t_nee & (s_ls["pdf"] > 0), s_shadow.t_max, 0.0))
            s_occ = traverse.trace_any(geom, s_shadow)
            n_ok = is_n & (s_ls["pdf"] > 0) & ~s_occ
            s_d2 = _sq(s_it.p - s_ls["p"])
            s_cos = fr.dot(s_ls["ng"], fr.normalize(s_it.p - s_ls["p"]))
            s_f = _eval_surface(compiled, s_it, swl4, -s_ray.direction, s_ls["wi"])
            jac = torch.abs(s_cos * _tile4(m_d2)) / (D_EPS + torch.abs(_tile4(m_cos) * s_d2))
            denom_n = t_ls_pdf + t_f_pdf + jac * s_pdf_div * (s_f["pdf"] + s_ls["pdf"])
            dn = torch.clamp(denom_n, min=D_EPS)[..., None]
            mc = _sel(n_ok, t_fL * t_weight / dn, mc)
            sc = _sel(n_ok, (jac * s_pdf_div)[..., None] * s_f["f"] * s_ls["L"] * s_weight / dn,
                      sc)
            ok = ok | n_ok

            if central:
                # the plain path tracer's NEE, once
                m_radiance = m_radiance + torch.where(
                    nee_valid[..., None],
                    m_f["f"] * ls["L"] * m_weight
                    / torch.clamp(ls["pdf"] + m_f["pdf"], min=D_EPS)[..., None], 0.0)
            else:
                mc = torch.where(t_nee[..., None], mc, 0.0)
                sc = torch.where((t_nee & ok)[..., None], sc, 0.0)
                m_radiance = m_radiance + _sum4(mc)
                s_radiance = s_radiance + sc
                s_gradient = s_gradient + (sc - mc)

        # ============ BSDF sampling and the emitter it reaches ============
        state, u_lobe = sampler.generate_1d(state)
        state, u_bsdf = sampler.generate_2d(state)
        state, u_rr = sampler.generate_1d(state)
        smp = surf_base.dispatch(compiled, m_it, "sample", swl, wo, u_lobe, u_bsdf, init={
            "f": m_it.p.new_zeros((n, c)), "pdf": m_it.p.new_zeros((n,)),
            "wi": torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3),
            "event": torch.zeros((n,), dtype=torch.int32, device=dev),
            "eta": m_it.p.new_ones((n,))})
        m_alive2 = m_alive & (smp["pdf"] > 0)

        prev_it, prev_ray = m_it, m_ray
        new_ray = ct.spawn_ray(prev_it, smp["wi"])
        new_ray = new_ray._replace(t_max=torch.where(m_alive2, new_ray.t_max, 0.0))
        new_it = surface_interaction(compiled.arrays, traverse.trace_closest(geom, new_ray),
                                     new_ray, needs_uv=plan.needs_uv)
        new_it = new_it._replace(valid=new_it.valid & m_alive2)
        m_emit, m_lum_pdf, m_hit_emitter = _emitter_at(compiled, light_sampler, new_it, new_ray,
                                                       swl)
        m_emit = torch.where(m_alive2[..., None], m_emit, 0.0)
        # the environment counts as diffuse
        m_next_diffuse = torch.where(new_it.valid,
                                     _vertex_diffuse(compiled, new_it, shift_threshold), True)
        env_escape = m_alive2 & ~new_it.valid
        if not plan.has_environment:
            # escaped with no environment: no emitter, the path just ends
            m_hit_emitter = m_hit_emitter & new_it.valid

        m_pdf = smp["pdf"]
        m_prev_weight = m_weight
        m_weight = torch.where(m_alive2[..., None],
                               m_weight * safe_div(smp["f"], m_pdf[..., None]), m_weight)
        m_weight_mis2 = m_prev_weight / torch.clamp(m_lum_pdf + m_pdf, min=D_EPS)[..., None]

        # ---- the main path's quantities on the shift axis ----
        t_alive2 = _tile4(m_alive2)
        t_pdf = _tile4(m_pdf)
        t_lum = _tile4(m_lum_pdf)
        t_emit = _tile4(m_emit)
        t_f = _tile4(smp["f"])
        t_prev_w = _tile4(m_prev_weight)
        t_prev_it = _tile4(prev_it)
        t_new_it = _tile4(new_it)
        t_new_dir = _tile4(new_ray.direction)
        prev_pdf_div = s_pdf_div
        s_alive_in = s_alive

        upd = s_alive & t_alive2  # lanes whose shifted state evolves
        # a failed shift's fallback
        mc = torch.where(t_alive2[..., None], _tile4(m_weight_mis2) * t_emit * t_f, 0.0)
        sc = torch.zeros_like(mc)
        s_end = torch.zeros((4 * n,), dtype=torch.bool, device=dev)

        # --- CONNECTED ---
        s_prev_weight = s_weight
        is_c = upd & (s_status == CONNECTED)
        denom_c = t_lum + t_pdf + prev_pdf_div * (t_pdf + t_lum)
        dc = torch.clamp(denom_c, min=D_EPS)[..., None]
        s_weight = _sel(is_c, s_prev_weight * safe_div(t_f, t_pdf[..., None]), s_weight)
        mc = _sel(is_c, t_f * t_emit * t_prev_w / dc, mc)
        sc = _sel(is_c, t_f * t_emit * s_prev_weight * prev_pdf_div[..., None] / dc, sc)

        # --- RECENTLY_CONNECTED ---
        is_r = upd & (s_status == RECENTLY_CONNECTED)
        inc_r = fr.normalize(s_it.p - t_prev_it.p)
        r_eval = _eval_surface(compiled, t_prev_it, swl4, inc_r, t_new_dir)
        r_dead = is_r & (r_eval["pdf"] <= 0)
        r_live = is_r & (r_eval["pdf"] > 0)
        s_weight = _sel(r_live, s_prev_weight * safe_div(t_f * 0 + r_eval["f"],
                                                         r_eval["pdf"][..., None]), s_weight)
        s_pdf_div = torch.where(
            r_live, prev_pdf_div * r_eval["pdf"] / torch.clamp(t_pdf, min=D_EPS), s_pdf_div)
        s_status = torch.where(r_live, CONNECTED, s_status)
        denom_r = t_lum + t_pdf + prev_pdf_div * (r_eval["pdf"] + t_lum)
        dr = torch.clamp(denom_r, min=D_EPS)[..., None]
        mc = _sel(r_live, t_f * t_emit * t_prev_w / dr, mc)
        sc = _sel(r_live, r_eval["f"] * t_emit * s_prev_weight * prev_pdf_div[..., None] / dr,
                  sc)
        s_alive = s_alive & ~r_dead

        # --- NOT_CONNECTED: the reconnection shift ---
        recon_class = _tile4(m_diffuse) & _tile4(m_next_diffuse) & s_diffuse
        is_nc = upd & (s_status == NOT_CONNECTED)
        try_recon = is_nc & recon_class & (
            (not last_segment) | _tile4(m_hit_emitter))
        # visibility from the shifted vertex to the main path's next vertex
        vis_ray = ct.spawn_ray_to(s_it, t_new_it.p, t_new_it.ng)
        vis_ray = vis_ray._replace(t_max=torch.where(
            try_recon & _tile4(new_it.valid), vis_ray.t_max, 0.0))
        vis_occ = traverse.trace_any(geom, vis_ray)
        # the environment shift: the shifted origin, the main path's
        # escape direction
        env_ray = ct.spawn_ray(s_it, t_new_dir)
        env_ray = env_ray._replace(t_max=torch.where(
            try_recon & _tile4(env_escape), env_ray.t_max, 0.0))
        env_occ = traverse.trace_any(geom, env_ray)

        main_edge = t_prev_it.p - t_new_it.p
        shift_edge = s_it.p - t_new_it.p
        m_el2 = _sq(main_edge)
        s_el2 = _sq(shift_edge)
        recon_wo = -shift_edge / torch.sqrt(torch.clamp(s_el2, min=1e-20))[..., None]
        m_opp_cos = fr.dot(main_edge, t_new_it.ns) / torch.sqrt(torch.clamp(m_el2, min=1e-20))
        s_opp_cos = fr.dot(recon_wo, t_new_it.ns)
        jac_geo = torch.abs(s_opp_cos * m_el2) / (D_EPS + torch.abs(m_opp_cos * s_el2))
        hit_case = _tile4(new_it.valid)
        shift_wo = torch.where(hit_case[..., None], recon_wo, t_new_dir)
        shift_jac = torch.where(hit_case, jac_geo, 1.0)
        shift_vis = torch.where(hit_case, ~vis_occ, ~env_occ)
        recon_ok = try_recon & shift_vis

        rc_eval = _eval_surface(compiled, s_it, swl4, -s_ray.direction, shift_wo)
        rc_live = recon_ok & (rc_eval["pdf"] > 0)
        s_weight = _sel(rc_live, s_prev_weight * safe_div(rc_eval["f"],
                                                          rc_eval["pdf"][..., None]), s_weight)
        s_pdf_div = torch.where(
            rc_live, prev_pdf_div * shift_jac * rc_eval["pdf"] / torch.clamp(t_pdf, min=D_EPS),
            s_pdf_div)
        s_status = torch.where(rc_live, RECENTLY_CONNECTED, s_status)
        # the emission seen through the reconnection
        sh_le = light_sampler.evaluate_hit(compiled, t_new_it, s_it.p, swl4)
        lit = _tile4(m_hit_emitter & new_it.valid)
        sh_emit = torch.where(hit_case[..., None],
                              torch.where(lit[..., None], sh_le["L"], 0.0), t_emit)
        sh_lum = torch.where(hit_case, torch.where(lit, sh_le["pdf"], 0.0), t_lum)
        denom_rc = t_lum + t_pdf + shift_jac * prev_pdf_div * (rc_eval["pdf"] + sh_lum)
        drc = torch.clamp(denom_rc, min=D_EPS)[..., None]
        rc_contrib = rc_live & _tile4(m_hit_emitter)
        mc = _sel(rc_contrib, t_f * t_emit * t_prev_w / drc, mc)
        sc = _sel(rc_contrib, rc_eval["f"] * sh_emit * s_prev_weight
                  * (shift_jac * prev_pdf_div)[..., None] / drc, sc)
        s_alive = s_alive & ~(try_recon & ~rc_live)
        s_alive = s_alive & ~(is_nc & recon_class & ~try_recon)

        # --- NOT_CONNECTED: the half-vector shift ---
        is_hv = is_nc & ~recon_class
        m_frame = _shading_frame(t_prev_it)
        s_frame = _shading_frame(s_it)
        ts_m_wo = fr.to_local(m_frame, _tile4(-prev_ray.direction))
        ts_m_wi = fr.to_local(m_frame, _tile4(smp["wi"]))
        ts_s_wi = fr.to_local(s_frame, -s_ray.direction)
        reflect_case = fr.cos_theta(ts_m_wi) * fr.cos_theta(ts_m_wo) >= 0.0

        # reflective: the classic half vector copied
        h = fr.normalize(ts_m_wo + ts_m_wi)
        ts_s_wo_r = fr.reflect(ts_s_wi, h)
        jac_r = torch.abs(fr.dot(ts_s_wo_r, h)) / (D_EPS + torch.abs(fr.dot(ts_m_wo, h)))
        ok_r = fr.cos_theta(ts_s_wi) * fr.cos_theta(ts_s_wo_r) > 0.0

        # transmissive: the generalized (Walter) half vector scaled by the
        # closures' etas, the shifted wi refracted about it with the
        # shifted vertex's eta; the Jacobian the ratio of the unnormalized
        # half vectors' squared norms times |m_wi . h| / |s_wo . h|
        eta_m = _tile4(surf_base.dispatch(compiled, prev_it, "eta_value", swl,
                                          init=prev_it.p.new_ones((n,))))
        eta_s = surf_base.dispatch(compiled, s_it, "eta_value", swl4,
                                   init=s_it.p.new_ones((4 * n,)))
        h_nn_main = torch.where((fr.cos_theta(ts_m_wo) < 0.0)[..., None],
                                -(ts_m_wo * eta_m[..., None] + ts_m_wi),
                                -(ts_m_wo + ts_m_wi * eta_m[..., None]))
        h_t = fr.normalize(h_nn_main)
        # ts_s_wi refracted about h_t, oriented to the incident side
        cos_sh = fr.dot(ts_s_wi, h_t)
        h_or = torch.where((cos_sh < 0.0)[..., None], -h_t, h_t)
        eta_rel = torch.where(cos_sh > 0.0, 1.0 / eta_s, eta_s)
        refr_ok, ts_s_wo_t = fr.refract(ts_s_wi, h_or, eta_rel)
        h_nn_shift = torch.where((fr.cos_theta(ts_s_wi) < 0.0)[..., None],
                                 -(ts_s_wi * eta_s[..., None] + ts_s_wo_t),
                                 -(ts_s_wi + ts_s_wo_t * eta_s[..., None]))
        jac_t = (_sq(h_nn_shift) / (D_EPS + _sq(h_nn_main))) * (
            torch.abs(fr.dot(ts_m_wi, h_t)) / (D_EPS + torch.abs(fr.dot(ts_s_wo_t, h_t))))
        ok_t = (refr_ok & (eta_m > 1.0 + 1e-6) & (eta_s > 1.0 + 1e-6)
                & (fr.cos_theta(ts_s_wi) * fr.cos_theta(ts_s_wo_t) < 0.0))

        ts_s_wo = torch.where(reflect_case[..., None], ts_s_wo_r, ts_s_wo_t)
        jac_hv = torch.where(reflect_case, jac_r, jac_t)
        hv_geom_ok = torch.where(reflect_case, ok_r, ok_t)
        hv_wo = fr.to_world(s_frame, ts_s_wo)
        hv_eval = _eval_surface(compiled, s_it, swl4, -s_ray.direction, hv_wo)
        hv_live = is_hv & hv_geom_ok & (hv_eval["pdf"] > 0)
        s_weight = _sel(hv_live, s_prev_weight * safe_div(hv_eval["f"],
                                                          hv_eval["pdf"][..., None]), s_weight)
        s_pdf_div = torch.where(
            hv_live, prev_pdf_div * jac_hv * hv_eval["pdf"] / torch.clamp(t_pdf, min=D_EPS),
            s_pdf_div)
        # the shifted ray advances through its own geometry
        hv_ray = ct.spawn_ray(s_it, hv_wo)
        hv_ray = hv_ray._replace(t_max=torch.where(hv_live, hv_ray.t_max, 0.0))
        hv_it = surface_interaction(compiled.arrays, traverse.trace_closest(geom, hv_ray),
                                    hv_ray, needs_uv=plan.needs_uv)
        hv_it = hv_it._replace(valid=hv_it.valid & hv_live)
        hv_emit, hv_lum, _ = _emitter_at(compiled, light_sampler, hv_it, hv_ray, swl4)
        hv_next_diffuse = torch.where(hv_it.valid,
                                      _vertex_diffuse(compiled, hv_it, shift_threshold), True)
        hv_miss = hv_live & ~hv_it.valid
        # the paths must stay alike: both escape or both hit, and a diffuse
        # chain is the reconnection's
        die = torch.zeros((4 * n,), dtype=torch.bool, device=dev)
        if plan.has_environment:
            die = die | (hv_miss & hit_case)  # the shifted path escaped, the main did not
            die = die | (hv_miss & ~hit_case & _tile4(m_diffuse) & s_diffuse)
        else:
            die = die | hv_miss
        die = die | (hv_live & hv_it.valid & ~hit_case)
        die = die | (hv_live & hv_it.valid & hit_case & _tile4(m_diffuse) & s_diffuse
                     & hv_next_diffuse)
        hv_ok = hv_live & ~die
        bh_main = sampling.balance_heuristic(t_pdf, t_lum)
        bh_shift = sampling.balance_heuristic(hv_eval["pdf"], hv_lum)
        d_hv_main = (1.0 / torch.clamp(bh_main, min=D_EPS)
                     + s_pdf_div / torch.clamp(bh_shift, min=D_EPS))
        d_hv_shift = (1.0 / torch.clamp(bh_main * s_pdf_div, min=D_EPS)
                      + 1.0 / torch.clamp(bh_shift, min=D_EPS))
        mc = _sel(hv_ok, _tile4(m_weight) * t_emit
                  / torch.clamp(d_hv_main, min=D_EPS)[..., None], mc)
        sc = _sel(hv_ok, s_weight * hv_emit / torch.clamp(d_hv_shift, min=D_EPS)[..., None], sc)
        # a failed half-vector shift: the central radiance, then the end
        hv_failed = is_hv & (~hv_geom_ok | (hv_eval["pdf"] <= 0) | die)
        mc = _sel(hv_failed, _tile4(m_weight) * t_emit * _tile4(
            sampling.balance_heuristic(m_pdf, m_lum_pdf))[..., None], mc)
        sc = _sel(hv_failed, torch.zeros_like(sc), sc)
        s_end = s_end | hv_failed | (hv_miss & hv_ok)
        # the shifted path's state advances only in the half-vector branch
        s_ray = _sel(hv_ok, hv_ray, s_ray)
        s_it = _sel(hv_ok, hv_it, s_it)

        # --- accumulate ---
        if central:
            # the plain path tracer's emission MIS, once
            m_radiance = m_radiance + torch.where(
                m_alive2[..., None], m_weight_mis2 * m_emit * smp["f"], 0.0)
        else:
            mc = torch.where(t_alive2[..., None], mc, 0.0)
            sc = torch.where((t_alive2 & s_alive_in)[..., None], sc, 0.0)
            m_radiance = m_radiance + _sum4(mc)
            s_radiance = s_radiance + sc
            s_gradient = s_gradient + (sc - mc)
        s_alive = s_alive & ~s_end

        # the main path advances
        m_it, m_ray = new_it, new_ray
        m_alive = m_alive2 & new_it.valid & (instances["surface_tag"][new_it.inst] >= 0)

        # --- Russian roulette on the main weight ---
        q = torch.clamp(m_weight.amax(dim=-1), min=0.05)
        do_rr = (q < rr_threshold) & (depth >= rr_depth)
        kill = do_rr & (u_rr >= q)
        m_alive = m_alive & ~kill
        scale = torch.where(do_rr & ~kill, 1.0 / q, 1.0)
        m_weight = m_weight * scale[..., None]
        s_weight = s_weight * _tile4(scale)[..., None]
        depth += 1

    if stats is not None:
        stats["iterations"] = stats.get("iterations", 0) + depth
    return {
        "very_direct": spectrum.srgb(very_direct, swl),
        "radiance": spectrum.srgb(m_radiance, swl),
        "neighbor": spectrum.srgb(s_radiance, swl4),
        "gradient": spectrum.srgb(s_gradient, swl4),
        "shift_alive": s_alive,
        "weight": torch.ones((n,), dtype=torch.float32, device=dev),
    }


def reconstruct_l2(primal, grad_x, grad_y, alpha=0.2, iters=60):
    """Screened Poisson L2 reconstruction (Kettunen et al. 2015 eq. 8):
    (alpha^2 I + grad^T grad) x = alpha^2 primal + grad^T g by `iters`
    conjugate-gradient steps from x = primal, on (H, W, 3) images; forward
    differences, gx[:, i] ~ I[:, i + 1] - I[:, i], 0 in the last column
    (row for gy)."""

    def dx(img):
        return torch.cat([img[:, 1:] - img[:, :-1], torch.zeros_like(img[:, :1])], dim=1)

    def dy(img):
        return torch.cat([img[1:] - img[:-1], torch.zeros_like(img[:1])], dim=0)

    def dxT(gx):
        # the adjoint of the forward difference in x
        left = torch.cat([torch.zeros_like(gx[:, :1]), gx[:, :-1]], dim=1)
        g = gx.clone()
        g[:, -1] = 0.0
        return left - g

    def dyT(gy):
        up = torch.cat([torch.zeros_like(gy[:1]), gy[:-1]], dim=0)
        g = gy.clone()
        g[-1] = 0.0
        return up - g

    a2 = alpha * alpha

    def A(x):
        return a2 * x + dxT(dx(x)) + dyT(dy(x))

    b = a2 * primal + dxT(grad_x) + dyT(grad_y)
    x = primal
    r = b - A(x)
    p = r
    rs = (r * r).sum()
    for _ in range(iters):
        Ap = A(p)
        alpha_k = rs / torch.clamp((p * Ap).sum(), min=1e-20)
        x = x + alpha_k * p
        r = r - alpha_k * Ap
        rs_new = (r * r).sum()
        p = r + (rs_new / torch.clamp(rs, min=1e-20)) * p
        rs = rs_new
    return x


def _roll(img, dx, dy):
    """img (H, W, ...) moved by (dx, dy) pixels; what wraps around is zeroed."""
    r = torch.roll(img, shifts=(dy, dx), dims=(0, 1))
    if dx == 1:
        r[:, 0] = 0.0
    elif dx == -1:
        r[:, -1] = 0.0
    if dy == 1:
        r[0] = 0.0
    elif dy == -1:
        r[-1] = 0.0
    return r


@register(SceneNodeTag.INTEGRATOR, "gpt", "GPT", "gradient", "GradientPathTracing")
class GradientPathTracing(ProgressiveIntegrator):
    """Defaults: depth 10, rr_depth 0, rr_threshold 0.95, shift_threshold
    0.1, central_radiance false, reconstruct true, reconstruct_alpha 0.2."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.max_depth = desc.int("depth", 10)
        self.rr_depth = desc.int("rr_depth", 0)
        self.rr_threshold = desc.float("rr_threshold", 0.95)
        self.shift_threshold = desc.float("shift_threshold", 0.1)
        self.central_radiance = desc.bool("central_radiance", False)
        self.reconstruct = desc.bool("reconstruct", True)
        self.recon_alpha = desc.float("reconstruct_alpha", 0.2)
        self._aux_buffers = {}
        # bounce-loop iterations of the last render()
        self.iterations_run = 0

    def sample(self, compiled, camera, pixel_xy, sample_index, stats=None):
        return gpt_trace_batch(
            compiled, camera, self.sampler, self.light_sampler, pixel_xy, sample_index,
            max_depth=self.max_depth, rr_depth=self.rr_depth, rr_threshold=self.rr_threshold,
            shift_threshold=self.shift_threshold, central=self.central_radiance,
            time=self.render_time, stats=stats)

    def _render_one_camera(self, compiled, camera):
        w, h = camera.film.resolution
        dev = compiled.device
        film = camera.film
        spp = camera.spp
        pixel_xy = pixel_grid(w, h, dev)
        accum = film.prepare(dev)
        gx = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)  # rgb + splat count
        gy = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
        eff = torch.zeros((h, w), dtype=torch.float32, device=dev)
        ones = torch.ones((h, w), dtype=torch.float32, device=dev)
        stats = {}
        for sample_index in range(spp):
            out = self.sample(compiled, camera, pixel_xy, sample_index, stats)
            if self.central_radiance:
                rgb = out["very_direct"] + out["radiance"]
                accum = film.accumulate_image(accum, rgb.reshape(h, w, 3),
                                              out["weight"].reshape(h, w))
                continue
            # the central pixel: emission 8x and MIS radiance 2x at a weight
            # of 4 (accumulate_image multiplies by the weight: the mean
            # enters)
            rgb_c = 2.0 * out["very_direct"] + 0.5 * out["radiance"]
            accum = film.accumulate_image(accum, rgb_c.reshape(h, w, 3),
                                          4.0 * out["weight"].reshape(h, w))
            # the neighbours' splats, 2x at a weight of 1: every shift is a
            # constant one-pixel offset, so each is a rolled image
            nb4 = (2.0 * out["neighbor"]).reshape(4, h, w, 3)
            alive4 = out["shift_alive"].to(torch.float32).reshape(4, h, w)
            for k, (sdx, sdy) in enumerate(PIXEL_SHIFTS):
                accum = film.accumulate_image(accum, _roll(nb4[k], sdx, sdy),
                                              _roll(ones, sdx, sdy))
                eff = eff + _roll(alive4[k], sdx, sdy)
            # gradients: right / bottom at the pixel (+), left / top at the
            # shifted pixel (-)
            g4 = (2.0 * (out["gradient"] - _tile4(out["very_direct"]))).reshape(4, h, w, 3)
            gx = gx + torch.cat([g4[0] + _roll(-g4[2], -1, 0),
                                 (ones + _roll(ones, -1, 0))[..., None]], dim=-1)
            gy = gy + torch.cat([g4[1] + _roll(-g4[3], 0, -1),
                                 (ones + _roll(ones, 0, -1))[..., None]], dim=-1)
        self.iterations_run += stats.get("iterations", 0)
        self.bounces_run += stats.get("iterations", 0)
        primal = film.develop(accum)
        if self.central_radiance:
            return primal
        gx = gx[..., :3] / torch.clamp(gx[..., 3:4], min=1.0)
        gy = gy[..., :3] / torch.clamp(gy[..., 3:4], min=1.0)
        self._aux_buffers[camera.file] = {
            "gradient_x": gx,
            "gradient_y": gy,
            "effective": eff[..., None] / spp * torch.ones((1, 1, 3), device=dev),
        }
        if self.reconstruct:
            return reconstruct_l2(primal, gx, gy, alpha=self.recon_alpha)
        return primal

    def render(self, compiled, save: bool = False) -> dict:
        self.iterations_run = 0
        results = super().render(compiled, save=save)
        for file, bufs in self._aux_buffers.items():
            stem, ext = os.path.splitext(file)
            for key, img in bufs.items():
                name = f"{stem}_{key}{ext}"
                results[name] = img.cpu().numpy()
                if save:
                    imageio.save_image(name, results[name])
        self._aux_buffers = {}
        return results
