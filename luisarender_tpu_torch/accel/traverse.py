"""Ray intersection: the routing of closest / any-hit traces.

Counterpart of luisarender_tpu/accel/traverse.py (`trace_closest` /
`trace_any`), routed as the reference routes (traverse.py:472-540). A scene
without the cluster kernel's tables (the scene compiler builds them above
brute.MAX_TRIS triangles) traces with the brute-force kernels of
ops/brute.py. Above that, closest hits go to ops/subpacket.py when its
route is enabled (`LR_SUBPACKET=1`) and the scene has its 8-wide tables,
else to ops/wide8.py when that route is enabled (`LR_WIDE8=1`) and the
tables are there, else to ops/cluster.py; any-hit traces go to wide8 on
the same condition, else to cluster. Analytic spheres are exact quadrics
tested before the triangles, whose trace they clip. A two-level scene's
geometry (accel/twolevel.py TraceGeometry2L) traces with one cluster
trace a visible instance (`trace_closest_2l_cluster` /
`trace_any_2l_cluster`), which raise where its cluster tables are missing.

Hit.prim is the triangle's slot in the scene's SAH order (the row of the
shade table), P + s for sphere s (P = the triangle rows); -1 = miss. A
subpacket hit carries bary = NaN: scene/geometry.py recomputes (u, v).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core.types import Hit
from ..ops import brute, cluster, subpacket, wide8
from . import twolevel


class TraceGeometry(NamedTuple):
    num_rows: int  # P, the triangle rows in SAH order
    # (P, 16) float32, ops/brute.py layout; None with cluster tables
    tri_table: Optional[torch.Tensor] = None
    # ops/cluster.py tables; None for a brute-force scene
    cluster_nodes: Optional[torch.Tensor] = None  # (N, 8) float32
    cluster_tris: Optional[torch.Tensor] = None  # (C, 16, 128) float32
    # the 8-wide tables of ops/subpacket.py and ops/wide8.py; None unless an
    # opt-in route asked for them at compile
    cluster_woop: Optional[torch.Tensor] = None  # (C, 8, 1024) float32
    cluster_slab8: Optional[torch.Tensor] = None  # (N8, 8, 128) float32
    cluster_meta8: Optional[torch.Tensor] = None  # (N8, 16) float32
    cluster_cboxes: Optional[torch.Tensor] = None  # (C, 8) float32
    # the 8-wide walk's stack bound (ops/subpacket.py stack8_need); None:
    # computed from cluster_meta8 at each trace
    stack8: Optional[int] = None
    # analytic spheres (S, 16): 0:3 center, 3 radius, 4:13 rotation
    # (row-major), 13 instance id, 14 opaque; None without spheres
    sph: Optional[torch.Tensor] = None
    # the binary SAH tree (accel/bvh.py BVHArrays layout) and the triangle
    # rows in its order, which ops/trace.py pack_tables reads
    tri_v0: Optional[torch.Tensor] = None  # (P, 3) float32
    tri_e1: Optional[torch.Tensor] = None  # (P, 3) float32
    tri_e2: Optional[torch.Tensor] = None  # (P, 3) float32
    prim_index: Optional[torch.Tensor] = None  # (P,) int, -1 for padding
    aabb_min: Optional[torch.Tensor] = None  # (N, 3) float32
    aabb_max: Optional[torch.Tensor] = None  # (N, 3) float32
    skip: Optional[torch.Tensor] = None  # (N,) int32
    node_first: Optional[torch.Tensor] = None  # (N,) int32
    node_count: Optional[torch.Tensor] = None  # (N,) int32
    leaf_size: int = 4


def _use_subpacket(geom) -> bool:
    return (subpacket.ENABLED and geom.cluster_woop is not None
            and geom.cluster_slab8 is not None)


def _use_wide8(geom) -> bool:
    return (wide8.ENABLED and geom.cluster_slab8 is not None
            and geom.cluster_cboxes is not None)


def intersect_tri(o, d, v0, e1, e2):
    """Moller-Trumbore of rays against triangles, all (..., 3), in the
    reference's order (its jnp.cross and three-term sums): (valid, t, u,
    v)."""
    big_det, inside, t, u, v = brute.mt_uvt(*v0.unbind(-1), *e1.unbind(-1), *e2.unbind(-1),
                                            *o.unbind(-1), *d.unbind(-1))
    return big_det & inside, t, u, v


def _sphere_roots(row, o, d):
    c = row[0:3]
    r = row[3]
    oc = o - c
    b = (oc * d).sum(-1)
    c2 = (oc * oc).sum(-1) - r * r
    disc = b * b - c2
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    return disc, -b - sq, -b + sq


def sphere_closest(sph, rays):
    """Closest analytic-sphere hit: (t (inf on miss), index (-1), u, v),
    uv in the icosphere's parameterization of the sphere's local frame:
    v = acos(z) / pi, u = atan2(y, x) / 2pi mod 1."""
    o, d = rays.origin, rays.direction
    best_t = torch.full(o.shape[:-1], math.inf, device=o.device)
    best_i = torch.full(o.shape[:-1], -1, dtype=torch.int32, device=o.device)
    for s, row in enumerate(sph.unbind(0)):
        disc, t0, t1 = _sphere_roots(row, o, d)
        t = torch.where((t0 > rays.t_min) & (t0 < rays.t_max), t0, t1)
        ok = (disc > 0.0) & (t > rays.t_min) & (t < rays.t_max) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_i = torch.where(ok, s, best_i)
    srow = sph[torch.clamp(best_i, min=0)]
    r = torch.clamp(srow[..., 3], min=1e-20)
    n = (o + best_t[..., None] * d - srow[..., 0:3]) / r[..., None]
    rot = srow[..., 4:13]
    lx = n[..., 0] * rot[..., 0] + n[..., 1] * rot[..., 3] + n[..., 2] * rot[..., 6]
    ly = n[..., 0] * rot[..., 1] + n[..., 1] * rot[..., 4] + n[..., 2] * rot[..., 7]
    lz = n[..., 0] * rot[..., 2] + n[..., 1] * rot[..., 5] + n[..., 2] * rot[..., 8]
    v = torch.arccos(torch.clamp(lz, -1.0, 1.0)) * (1.0 / math.pi)
    u = torch.atan2(ly, lx) * (0.5 / math.pi)
    u = torch.where(u < 0.0, u + 1.0, u)
    found = best_i >= 0
    return (torch.where(found, best_t, math.inf), best_i,
            torch.where(found, u, 0.0), torch.where(found, v, 0.0))


def sphere_any(sph, rays):
    """Occlusion by any opaque analytic sphere within (t_min, t_max)."""
    occ = torch.zeros(rays.origin.shape[:-1], dtype=torch.bool, device=rays.origin.device)
    for row in sph.unbind(0):
        disc, t0, t1 = _sphere_roots(row, rays.origin, rays.direction)
        hit0 = (t0 > rays.t_min) & (t0 < rays.t_max)
        hit1 = (t1 > rays.t_min) & (t1 < rays.t_max)
        occ = occ | ((disc > 0.0) & (hit0 | hit1) & (row[14] > 0.0))
    return occ


def _ray_args(rays):
    return rays.origin, rays.direction, rays.t_min, rays.t_max


def _trace_closest_tris(geom, rays) -> Hit:
    if geom.cluster_nodes is None:
        t, slot, u, v = brute.closest(*_ray_args(rays), geom.tri_table)
    elif _use_subpacket(geom):
        t, slot, u, v = subpacket.closest(*_ray_args(rays), geom.cluster_slab8,
                                          geom.cluster_meta8, geom.cluster_woop, geom.stack8)
    elif _use_wide8(geom):
        t, slot, u, v = wide8.closest(*_ray_args(rays), geom.cluster_slab8,
                                      geom.cluster_meta8, geom.cluster_cboxes,
                                      geom.cluster_tris, geom.stack8)
    else:
        t, slot, u, v = cluster.closest(*_ray_args(rays), geom.cluster_nodes,
                                        geom.cluster_tris)
    found = slot >= 0
    return Hit(
        inst=torch.where(found, 0, -1).to(torch.int32),
        prim=slot,
        bary=torch.stack([u, v], dim=-1),
        t=t,
    )


def trace_closest(geom: TraceGeometry, rays) -> Hit:
    if isinstance(geom, twolevel.TraceGeometry2L):
        return twolevel.trace_closest_2l_cluster(geom, rays)
    if geom.sph is None:
        return _trace_closest_tris(geom, rays)
    # spheres first; their hits clip the triangle trace, whose hit wins
    t_s, i_s, u_s, v_s = sphere_closest(geom.sph, rays)
    hit = _trace_closest_tris(geom, rays._replace(t_max=torch.minimum(rays.t_max, t_s)))
    sph_wins = (i_s >= 0) & ~(hit.prim >= 0)
    return Hit(
        inst=torch.where(sph_wins, 0, hit.inst).to(torch.int32),
        prim=torch.where(sph_wins, geom.num_rows + i_s, hit.prim),
        bary=torch.where(sph_wins[..., None], torch.stack([u_s, v_s], dim=-1), hit.bary),
        t=torch.where(sph_wins, t_s, hit.t),
    )


def trace_any(geom: TraceGeometry, rays):
    """Shadow-ray occlusion; returns bool occluded per ray."""
    if isinstance(geom, twolevel.TraceGeometry2L):
        return twolevel.trace_any_2l_cluster(geom, rays)
    occ = None
    if geom.sph is not None:
        occ = sphere_any(geom.sph, rays)
        # occluded lanes skip the triangle trace
        rays = rays._replace(t_max=torch.where(occ, 0.0, rays.t_max))
    if geom.cluster_nodes is None:
        tri = brute.any_hit(*_ray_args(rays), geom.tri_table)
    elif _use_wide8(geom):
        tri = wide8.any_hit(*_ray_args(rays), geom.cluster_slab8, geom.cluster_meta8,
                            geom.cluster_cboxes, geom.cluster_tris, geom.stack8)
    else:
        tri = cluster.any_hit(*_ray_args(rays), geom.cluster_nodes, geom.cluster_tris)
    return tri if occ is None else occ | tri
