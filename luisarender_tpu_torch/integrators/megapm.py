"""Stochastic progressive photon mapping (SPPM).

Counterpart of luisarender_tpu/integrators/megapm.py. An iteration (one
sample of every pixel) runs four parts, with no host read between them:

  emit      photons_per_iter photons from the lights (lights/base.py
            dispatch_sample_le): a light picked uniformly, a fixed walk of
            photon_depth bounces over all lanes, a deposit at every real
            surface from the second bounce on, Russian roulette relative
            to the emitted power;
  grid      the photons' cells of a grid_resolution^3 grid over the world
            bounds, a stable sort by cell id (within a cell the lower
            photon slot first), each cell capped at cell_budget photons and
            the table at table_rows cells in cell-id order, the survivors
            written into a dense (table_rows + 1, fields * cell_budget)
            table of whole cells, field-major; row table_rows is empty;
  camera    at most min(depth, 4) bounces with NEE at every vertex
            (integrators/common.py shade_surface), latching the first hit
            whose roughness exceeds 0.3 as the pixel's gather point;
  gather    the 27 cells around each gather point, whole rows of the table,
            the photons within the radius on the front side summed:
            albedo / pi * power / (pi r^2 photons_per_iter).

The radius shrinks from iteration to iteration by the SPPM shared-radius
rule, r_{i+1}^2 = r_i^2 (i + alpha) / (i + 1), computed in float64 on the
host and stored as float32. Kept rows are selected by mask before they are
written (the reference writes past the end and has XLA drop the writes).
The gather takes GATHER_BLOCK gather points at a time, which bounds its
rows in memory (27 * GATHER_BLOCK * fields * cell_budget floats) and
leaves each pixel's sum unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel import traverse
from ..core import sampling
from ..core import types as ct
from ..core.spectrum import safe_div
from ..lights.base import dispatch_sample_le
from ..scene.geometry import surface_interaction
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..surfaces import base as surf_base
from . import common
from .base import ProgressiveIntegrator
from .mega_path import pixel_grid, wavelengths

# gather points a block of the gather
GATHER_BLOCK = 16384

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def _sample_init(n, c, device):
    return {
        "f": torch.zeros((n, c), dtype=torch.float32, device=device),
        "pdf": torch.zeros((n,), dtype=torch.float32, device=device),
        "wi": torch.tensor([0.0, 0.0, 1.0], device=device).expand(n, 3),
        "event": torch.zeros((n,), dtype=torch.int32, device=device),
        "eta": torch.ones((n,), dtype=torch.float32, device=device),
    }


def _cells(p, wmin, ext, g):
    """The grid cell (N, 3) int32 of each point, clamped into the grid."""
    return torch.clamp(((p - wmin) / ext * g).to(torch.int32), 0, g - 1)


@register(SceneNodeTag.INTEGRATOR, "photon", "Photon", "megapm", "MegaPM", "sppm", "SPPM")
class PhotonMapping(ProgressiveIntegrator):
    """Defaults: depth 10, photons_per_iter 65,536, photon_depth 5,
    initial_radius 0.01 of the world's diagonal, alpha 0.7,
    grid_resolution 64, cell_budget 32, table_rows 32,768."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.max_depth = desc.int("depth", 10)
        self.photons_per_iter = desc.int("photons_per_iter", 65536)
        self.photon_depth = desc.int("photon_depth", 5)
        self.initial_radius_scale = desc.float("initial_radius", 0.01)
        self.alpha = desc.float("alpha", 0.7)
        self.grid_res = desc.int("grid_resolution", 64)
        self.cell_budget = desc.int("cell_budget", 32)
        self.table_rows = desc.int("table_rows", 32768)

    # -------------------- photon pass --------------------
    def _emit_photons(self, compiled, iteration):
        """Photon SoA of one iteration, a slot per (bounce from the second
        on, photon), bounce-major: p (M, 3), power (M, C), wi (M, 3) (toward
        where the photon came from), valid (M,)."""
        sampler = self.sampler
        plan = compiled.plan
        geom = compiled.trace_geometry()
        instances = compiled.arrays["instances"]
        dev = compiled.device
        n = self.photons_per_iter
        c = plan.spectral_dim

        ids = torch.arange(n, dtype=torch.int32, device=dev)
        pixel_xy = torch.stack([ids % 8192, ids // 8192], dim=-1)
        state = sampler.start(pixel_xy, iteration + (1 << 20))
        state, swl = wavelengths(compiled.spectrum, sampler, state, pixel_xy)

        # a light picked uniformly, then a photon emitted from it
        state, u_pick = sampler.generate_1d(state)
        n_lights = plan.num_lights
        entry_idx = torch.clamp((u_pick * n_lights).to(torch.int32), 0, n_lights - 1)
        state, u_pos = sampler.generate_2d(state)
        state, u_dir = sampler.generate_2d(state)
        emission = dispatch_sample_le(compiled, entry_idx.long(), u_pos, u_dir, swl)
        beta = emission["weight"] * float(n_lights)  # 1 / p(light)
        beta0_max = torch.clamp(beta.amax(dim=-1), min=1e-9)  # RR's reference
        ray = ct.make_ray(ct.offset_ray_origin(emission["p"], emission["ng"]), emission["wi"])

        # the first bounce deposits nothing (direct light is NEE's)
        n_dep = max(self.photon_depth - 1, 1)
        ph_p = torch.zeros((n_dep, n, 3), dtype=torch.float32, device=dev)
        ph_power = torch.zeros((n_dep, n, c), dtype=torch.float32, device=dev)
        ph_wi = torch.zeros((n_dep, n, 3), dtype=torch.float32, device=dev)
        ph_valid = torch.zeros((n_dep, n), dtype=torch.bool, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        for d in range(self.photon_depth):
            # dead lanes traced with t_max 0: they find nothing, as the
            # reference's hits on them are masked
            hit = traverse.trace_closest(
                geom, ray._replace(t_max=torch.where(active, ray.t_max, 0.0)))
            it = surface_interaction(compiled.arrays, hit, ray, needs_uv=plan.needs_uv)
            it = it._replace(valid=it.valid & active)
            has_surface = (instances["surface_tag"][it.inst] >= 0) & it.valid
            wo = -ray.direction
            if d > 0:
                ph_p[d - 1] = it.p
                ph_power[d - 1] = beta
                ph_wi[d - 1] = wo
                ph_valid[d - 1] = has_surface
            state, u_lobe = sampler.generate_1d(state)
            state, u_bsdf = sampler.generate_2d(state)
            state, u_rr = sampler.generate_1d(state)
            s = surf_base.dispatch(compiled, it._replace(valid=has_surface), "sample", swl, wo,
                                   u_lobe, u_bsdf, init=_sample_init(n, c, dev))
            new_ray = ct.spawn_ray(it, s["wi"])
            a3 = active[..., None]
            ray = ct.Ray(
                origin=torch.where(a3, new_ray.origin, ray.origin),
                direction=torch.where(a3, new_ray.direction, ray.direction),
                t_min=torch.where(active, new_ray.t_min, ray.t_min),
                t_max=torch.where(active, new_ray.t_max, ray.t_max),
            )
            beta = torch.where(a3, beta * safe_div(s["f"], s["pdf"][..., None]), beta)
            # Russian roulette on the photon's power
            q = torch.clamp(beta.amax(dim=-1) / beta0_max, 0.05, 1.0)
            kill = u_rr >= q
            beta = beta * torch.where(kill, 0.0, 1.0 / q)[..., None]
            active = active & has_surface & (s["pdf"] > 0) & ~kill
        m = n_dep * n
        return (ph_p.reshape(m, 3), ph_power.reshape(m, c), ph_wi.reshape(m, 3),
                ph_valid.reshape(m))

    # -------------------- grid build --------------------
    def _build_grid(self, compiled, photons):
        """(cellrow, table): cellrow (g^3 + 1,) int32 maps a cell id to its
        table row (-1: empty); table (table_rows + 1, F * cell_budget), a
        row a cell, field-major: px py pz wx wy wz power[C] flag, each
        field's cell_budget photons side by side; row table_rows is zero."""
        ph_p, ph_power, ph_wi, ph_valid = photons
        dev = ph_p.device
        g = self.grid_res
        g3 = g * g * g
        m = ph_p.shape[0]
        c = ph_power.shape[-1]
        budget = self.cell_budget
        rows = self.table_rows
        wmin = compiled.arrays["world_min"]
        ext = torch.clamp(compiled.arrays["world_max"] - wmin, min=1e-6)
        cell = _cells(ph_p, wmin, ext, g)
        cell_id = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
        cell_id = torch.where(ph_valid, cell_id, g3)  # invalid -> past every cell

        sc, order = torch.sort(cell_id, stable=True)
        iota = torch.arange(m, dtype=torch.int32, device=dev)
        boundary = torch.ones((m,), dtype=torch.bool, device=dev)
        boundary[1:] = sc[1:] != sc[:-1]
        run_start = torch.cummax(torch.where(boundary, iota, 0), dim=0).values
        rank = iota - run_start
        real = sc < g3
        # a kept cell's row: the distinct real cells before it
        newcell = boundary & real
        rowidx = torch.cumsum(newcell.to(torch.int32), dim=0, dtype=torch.int32) - 1
        ok = (rank < budget) & real & (rowidx < rows)

        cellrow = torch.full((g3 + 1,), -1, dtype=torch.int32, device=dev)
        first = newcell & (rowidx < rows)
        cellrow[sc[first].long()] = rowidx[first]

        f = 7 + c  # px py pz wx wy wz power[c] flag
        keep = order[ok]
        payload = torch.cat([ph_p[keep], ph_wi[keep], ph_power[keep],
                             torch.ones((keep.shape[0], 1), dtype=torch.float32, device=dev)],
                            dim=-1)
        slot = (rowidx[ok] * budget + rank[ok]).long()
        table = torch.zeros(((rows + 1) * budget, f), dtype=torch.float32, device=dev)
        table[slot] = payload
        table = table.reshape(rows + 1, budget, f).transpose(1, 2)
        return cellrow, table.reshape(rows + 1, f * budget)

    # -------------------- camera pass --------------------
    def _camera_pass(self, compiled, camera, pixel_xy, sample_index, grid, radius, n_emitted):
        """One sample of each pixel of pixel_xy: NEE along at most
        min(depth, 4) bounces and the photon density at the latched gather
        point. Returns (rgb (N, 3), weight (N,) of ones)."""
        sampler = self.sampler
        light_sampler = self.light_sampler
        plan = compiled.plan
        geom = compiled.trace_geometry()
        instances = compiled.arrays["instances"]
        dev = pixel_xy.device
        n = pixel_xy.shape[0]
        c = plan.spectral_dim

        state = sampler.start(pixel_xy, sample_index)
        state, u_filter = sampler.generate_pixel_2d(state)
        # the lens at its centre, as in the reference
        ray, _, cam_weight = camera.generate_rays(
            pixel_xy, u_filter, torch.full((n, 2), 0.5, dtype=torch.float32, device=dev), 0.0)
        state, swl = wavelengths(compiled.spectrum, sampler, state, pixel_xy)

        beta = cam_weight[..., None].expand(n, c)
        L = torch.zeros((n, c), dtype=torch.float32, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        pdf_bsdf = torch.full((n,), 1e16, dtype=torch.float32, device=dev)
        eta_scale = torch.ones((n,), dtype=torch.float32, device=dev)
        gathered = torch.zeros((n,), dtype=torch.bool, device=dev)
        # the latched gather point: position, shading normal, beta albedo / pi
        gp_p = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        gp_ns = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        gp_coef = torch.zeros((n, c), dtype=torch.float32, device=dev)
        n_rays = torch.zeros((), dtype=torch.int64, device=dev)

        for _ in range(min(self.max_depth, 4)):
            hit = traverse.trace_closest(
                geom, ray._replace(t_max=torch.where(active, ray.t_max, 0.0)))
            it = surface_interaction(compiled.arrays, hit, ray, needs_uv=plan.needs_uv)
            it = it._replace(valid=it.valid & active)
            wo = -ray.direction
            if plan.num_lights > 0:
                has_light = instances["light_tag"][it.inst] >= 0
                le = light_sampler.evaluate_hit(compiled, it, ray.origin, swl)
                mis_w = sampling.balance_heuristic(pdf_bsdf, le["pdf"])
                L = torch.where((active & has_light)[..., None],
                                L + beta * le["L"] * mis_w[..., None], L)
            has_surface = (instances["surface_tag"][it.inst] >= 0) & it.valid
            active = active & has_surface

            state, u_sel = sampler.generate_1d(state)
            state, u_light = sampler.generate_2d(state)
            state, u_lobe = sampler.generate_1d(state)
            state, u_bsdf = sampler.generate_2d(state)
            L, ray2, beta2, pdf2, eta2, shade_ok, n_rays, _ = common.shade_surface(
                compiled, light_sampler, it, wo, swl, L, ray, beta, pdf_bsdf, eta_scale,
                active, n_rays, (u_sel, u_light, u_lobe, u_bsdf))
            # latch the gather point at the first diffuse-ish hit
            rough = surf_base.dispatch(
                compiled, it, "roughness",
                init=torch.ones((n, 2), dtype=torch.float32, device=dev))
            diffuse_here = active & (rough.amax(dim=-1) > 0.3) & ~gathered
            albedo = surf_base.dispatch(
                compiled, it, "albedo", swl,
                init=torch.zeros((n, c), dtype=torch.float32, device=dev))
            m3 = diffuse_here[..., None]
            gp_p = torch.where(m3, it.p, gp_p)
            gp_ns = torch.where(m3, it.ns, gp_ns)
            gp_coef = torch.where(m3, beta * albedo * (1.0 / np.pi), gp_coef)
            gathered = gathered | diffuse_here
            active = active & shade_ok & ~gathered
            ray, beta, pdf_bsdf, eta_scale = ray2, beta2, pdf2, eta2

        L = L + self._gather(compiled, gp_p, gp_ns, gp_coef, gathered, grid, radius, n_emitted)
        rgb = compiled.spectrum.srgb(L, swl)
        return rgb, torch.ones((n,), dtype=torch.float32, device=dev)

    def _gather(self, compiled, gp_p, gp_ns, gp_coef, gp_valid, grid, radius, n_emitted):
        """The indirect radiance at the gather points (N, C): the photons
        of the 27 cells around each point within `radius` (a float32) on
        the front side of its shading normal, their power summed, times
        gp_coef / (pi r^2 n_emitted); 0 where gp_valid is False. A
        neighbour cell outside the grid reads the empty row."""
        cellrow, table = grid
        dev = gp_p.device
        g = self.grid_res
        c = gp_coef.shape[-1]
        budget = self.cell_budget
        f = 7 + c
        rows = self.table_rows
        wmin = compiled.arrays["world_min"]
        ext = torch.clamp(compiled.arrays["world_max"] - wmin, min=1e-6)
        r2 = np.float32(radius) * np.float32(radius)
        norm = np.float32(1.0) / (np.float32(np.pi) * r2 * np.float32(n_emitted))
        offsets = torch.tensor(_OFFSETS, dtype=torch.int32, device=dev)
        totals = []
        for b0 in range(0, gp_p.shape[0], GATHER_BLOCK):
            qp, qn = gp_p[b0:b0 + GATHER_BLOCK], gp_ns[b0:b0 + GATHER_BLOCK]
            n = qp.shape[0]
            cc = _cells(qp, wmin, ext, g)[:, None, :] + offsets[None]
            in_grid = ((cc >= 0) & (cc < g)).all(dim=-1)
            cc = torch.clamp(cc, 0, g - 1)
            cid = (cc[..., 0] * g + cc[..., 1]) * g + cc[..., 2]  # (n, 27)
            row = cellrow[cid.long()]
            row = torch.where((row < 0) | ~in_grid, rows, row)
            # whole cell rows, field-major: ph[:, k] is field k's photons
            ph = table[row.reshape(-1).long()].reshape(n * 27, f, budget)
            qp = qp[:, None, :].expand(n, 27, 3).reshape(n * 27, 3)
            qn = qn[:, None, :].expand(n, 27, 3).reshape(n * 27, 3)
            d2 = ((ph[:, 0] - qp[:, 0:1]) ** 2 + (ph[:, 1] - qp[:, 1:2]) ** 2
                  + (ph[:, 2] - qp[:, 2:3]) ** 2)
            front = (ph[:, 3] * qn[:, 0:1] + ph[:, 4] * qn[:, 1:2] + ph[:, 5] * qn[:, 2:3]) > 0.0
            ok = (ph[:, 6 + c] > 0.0) & (d2 < r2) & front
            w = torch.where(ok, 1.0, 0.0)
            total = torch.stack([(ph[:, 6 + k] * w).sum(dim=-1) for k in range(c)], dim=-1)
            totals.append(total.reshape(n, 27, c).sum(dim=1))
        total = torch.cat(totals) if totals else gp_coef.new_zeros((0, c))
        return torch.where(gp_valid[..., None], gp_coef * total * norm, 0.0)

    # -------------------- the render loop --------------------
    def radii(self, compiled, spp):
        """The shared radius of each iteration (spp,) float32: the world
        diagonal times initial_radius, shrunk by r_{i+1}^2 = r_i^2 (i +
        alpha) / (i + 1) in float64."""
        wmin = compiled.arrays["world_min"].cpu().numpy()
        wmax = compiled.arrays["world_max"].cpu().numpy()
        r = float(np.linalg.norm(wmax - wmin)) * self.initial_radius_scale
        radii = np.empty((spp,), np.float32)
        for i in range(spp):
            radii[i] = r
            r = float(np.sqrt(r * r * (i + self.alpha) / (i + 1.0)))
        return radii

    def iteration(self, compiled, camera, pixel_xy, i, radius):
        """Iteration i (emit, grid, camera pass) at `radius`: (rgb, weight)."""
        photons = self._emit_photons(compiled, i)
        grid = self._build_grid(compiled, photons)
        return self._camera_pass(compiled, camera, pixel_xy, i, grid, radius,
                                 self.photons_per_iter)

    def _render_one_camera(self, compiled, camera):
        w, h = camera.film.resolution
        film = camera.film
        pixel_xy = pixel_grid(w, h, compiled.device)
        accum = film.prepare(compiled.device)
        for i, radius in enumerate(self.radii(compiled, camera.spp)):
            rgb, weight = self.iteration(compiled, camera, pixel_xy, i, radius)
            accum = film.accumulate_image(accum, rgb.reshape(h, w, 3), weight.reshape(h, w))
        return film.develop(accum)
