"""Hit -> Interaction reconstruction from the packed shade table.

Counterpart of luisarender_tpu/scene/geometry.py. All per-triangle shading
attributes live in one (P, SHADE_COLS) float32 table whose rows follow the
triangle table's order, so an interaction is one row gather plus
barycentric interpolation. The reference fetches rows by one-hot MXU
matmuls to dodge slow TPU gathers; here it is plain indexing. A two-level
scene (arrays["trace2"]) keeps one object-space table a unique mesh,
concatenated (`build_shade_table_object`), and its interaction moves the
row into world space by the hit instance's transform
(`surface_interaction_2l`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel.traverse import intersect_tri
from ..accel.twolevel import _xform_normal, _xform_point, _xform_vector
from ..core import frame as fr
from ..core.types import Hit, Interaction
from ..ops import subpacket

# Packed shade-table column layout (SHADE_COLS wide):
#   0:3   v0        3:6   e1        6:9   e2
#   9:12  ng (unit geometric normal)      12    prim_area
#   13:16 n0        16:19 n1        19:22 n2   (vertex normals)
#   22:24 uv0       24:26 uv1       26:28 uv2
#   28:31 tangent (dpdu; frame fallback when the uv mapping is degenerate)
#   31    instance id (exact float; unused in a two-level table)
#   32    valid flag (0 = padding row)
#   33    uv density: sqrt(uv-area / world-area); the uv-space area in a
#         two-level table
SHADE_COLS = 40


def _np_frame_tangent(n: np.ndarray) -> np.ndarray:
    """numpy make_frame()['s'] (Duff et al. 2017) for host fallbacks."""
    nz = n[:, 2]
    sign = np.where(nz >= 0.0, np.float32(1.0), np.float32(-1.0))
    a = np.float32(-1.0) / (sign + nz)
    b = n[:, 0] * n[:, 1] * a
    return np.stack(
        [1.0 + sign * n[:, 0] * n[:, 0] * a, sign * b, -sign * n[:, 0]],
        axis=-1,
    ).astype(np.float32)


def build_shade_table(
    vertex_p: np.ndarray,
    vertex_n: np.ndarray,
    vertex_uv: np.ndarray,
    triangles: np.ndarray,
    tri_inst: np.ndarray,
    prim_index: np.ndarray,
) -> np.ndarray:
    """Host-side (P, SHADE_COLS) table; row r describes original triangle
    prim_index[r] (-1 = padding)."""
    p = prim_index.shape[0]
    orig = np.maximum(prim_index, 0)
    tris = triangles[orig]
    v0 = vertex_p[tris[:, 0]].astype(np.float32)
    v1 = vertex_p[tris[:, 1]].astype(np.float32)
    v2 = vertex_p[tris[:, 2]].astype(np.float32)
    e1 = v1 - v0
    e2 = v2 - v0
    ng_raw = np.cross(e1, e2)
    ng_len = np.sqrt(np.maximum((ng_raw * ng_raw).sum(-1), 0.0))
    prim_area = (0.5 * ng_len).astype(np.float32)
    ng = (ng_raw / np.maximum(ng_len, 1e-20)[:, None]).astype(np.float32)

    n0 = vertex_n[tris[:, 0]].astype(np.float32)
    n1 = vertex_n[tris[:, 1]].astype(np.float32)
    n2 = vertex_n[tris[:, 2]].astype(np.float32)
    uv0 = vertex_uv[tris[:, 0]].astype(np.float32)
    uv1 = vertex_uv[tris[:, 1]].astype(np.float32)
    uv2 = vertex_uv[tris[:, 2]].astype(np.float32)

    # dpdu is constant per triangle (the uv mapping is affine over it)
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    safe_det = np.where(np.abs(det) < 1e-12, np.float32(1.0), det)
    dpdu = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) / safe_det[:, None]
    dpdu_len = np.sqrt(np.maximum((dpdu * dpdu).sum(-1), 0.0))
    degenerate = (np.abs(det) < 1e-12) | (dpdu_len < 1e-12)
    tangent = np.where(degenerate[:, None], _np_frame_tangent(ng), dpdu)

    table = np.zeros((p, SHADE_COLS), np.float32)
    table[:, 0:3] = v0
    table[:, 3:6] = e1
    table[:, 6:9] = e2
    table[:, 9:12] = ng
    table[:, 12] = prim_area
    table[:, 13:16] = n0
    table[:, 16:19] = n1
    table[:, 19:22] = n2
    table[:, 22:24] = uv0
    table[:, 24:26] = uv1
    table[:, 26:28] = uv2
    table[:, 28:31] = tangent.astype(np.float32)
    table[:, 31] = tri_inst[orig].astype(np.float32)
    table[:, 32] = (prim_index >= 0).astype(np.float32)
    uv_area = 0.5 * np.abs(det)
    table[:, 33] = np.sqrt(uv_area / np.maximum(prim_area, 1e-20)).astype(np.float32)
    return table


def build_shade_table_object(positions, normals, uvs, triangles, prim_index) -> np.ndarray:
    """One unique mesh's table for the two-level path, in object space and
    in the mesh's own SAH order: build_shade_table's layout, column 31
    unused (the hit carries the instance) and column 33 the uv-space area
    (the world-space area depends on the instance)."""
    table = build_shade_table(positions, normals, uvs, triangles,
                              np.zeros(triangles.shape[0], np.int32), prim_index)
    tris = triangles[np.maximum(prim_index, 0)]
    uv0 = uvs[tris[:, 0]].astype(np.float32)
    duv1 = uvs[tris[:, 1]].astype(np.float32) - uv0
    duv2 = uvs[tris[:, 2]].astype(np.float32) - uv0
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    table[:, 33] = (0.5 * np.abs(det)).astype(np.float32)
    return table


def surface_interaction_2l(arrays, hit: Hit, ray, needs_uv: bool = True,
                           cone_width=None) -> Interaction:
    """The interaction of a two-level hit: the object-space shade row
    (hit.prim) moved into world space by the instance's object-to-world
    transform (hit.inst's row, accel/twolevel.py layout), the shading
    normal by the inverse transpose; the area from the world-space edges.
    With a ray cone's width at the hit, the footprint is that width times
    the uv density sqrt(uv area (column 33) / world area)."""
    t2 = arrays["trace2"]
    shade = t2["shade_rows"]
    row = shade[torch.clamp(hit.prim, 0, shade.shape[0] - 1)]
    irow = t2["inst_rows"][torch.clamp(hit.inst, 0, t2["inst_rows"].shape[0] - 1)]
    valid = (hit.prim >= 0) & (hit.inst >= 0) & (row[..., 32] > 0.0)

    u = hit.bary[..., 0]
    v = hit.bary[..., 1]
    w = 1.0 - u - v
    p_obj = row[..., 0:3] + u[..., None] * row[..., 3:6] + v[..., None] * row[..., 6:9]
    p = _xform_point(irow, 12, p_obj)
    ng_raw = fr.cross(_xform_vector(irow, 12, row[..., 3:6]),
                      _xform_vector(irow, 12, row[..., 6:9]))
    prim_area = 0.5 * fr.length(ng_raw)
    ng = fr.normalize(ng_raw)

    ns_obj = (w[..., None] * row[..., 13:16] + u[..., None] * row[..., 16:19]
              + v[..., None] * row[..., 19:22])
    ns = fr.normalize(_xform_normal(irow, 0, ns_obj))
    ns = torch.where(
        (fr.length(ns) > 0.5)[..., None] & torch.isfinite(ns).all(dim=-1, keepdim=True),
        ns,
        ng,
    )
    ns = torch.where((fr.dot(ns, ng) < 0.0)[..., None], -ns, ns)
    if needs_uv:
        uv = (w[..., None] * row[..., 22:24] + u[..., None] * row[..., 24:26]
              + v[..., None] * row[..., 26:28])
    else:
        uv = torch.zeros_like(hit.bary)
    footprint = None
    if cone_width is not None:
        footprint = cone_width * torch.sqrt(row[..., 33] / torch.clamp(prim_area, min=1e-20))
    return Interaction(
        valid=valid,
        inst=torch.where(valid, hit.inst, -1),
        prim=hit.prim,
        p=p,
        ng=ng,
        ns=ns,
        tangent=_xform_vector(irow, 12, row[..., 28:31]),
        uv=uv,
        prim_area=prim_area,
        back_facing=fr.dot(-ray.direction, ng) < 0.0,
        footprint=footprint,
    )


def surface_interaction(arrays, hit: Hit, ray, needs_uv: bool = True,
                        cone_width=None) -> Interaction:
    """Interaction at each hit: one shade-row gather + interpolation, or, for
    an analytic-sphere hit (prim = P + sphere index), the exact quadric's
    point, normal and tangent rebuilt from its (u, v). needs_uv (the plan's:
    a texture reads uv) False leaves uv at zero and skips interpolating it.
    cone_width, the ray cone's width at each hit, gives the footprint: the
    width times the row's uv density (column 33), 1 / (2 pi r) on a sphere.
    A two-level scene's hits go to surface_interaction_2l."""
    if "trace2" in arrays:
        return surface_interaction_2l(arrays, hit, ray, needs_uv, cone_width)
    shade = arrays["trace"]["shade_table"]
    row = shade[torch.clamp(hit.prim, 0, shade.shape[0] - 1)]
    valid = (hit.prim >= 0) & (row[..., 32] > 0.0)

    u = hit.bary[..., 0]
    v = hit.bary[..., 1]
    # The subpacket route (ops/subpacket.py) returns bary = NaN: its Woop
    # test's u, v are a rearrangement of Moller-Trumbore, so the exact ones
    # are recomputed here from the winner's shade row, as in the reference,
    # and only while that route is enabled (every other trace's bary is
    # exact). Misses and rejected rows get 0, never NaN.
    if subpacket.ENABLED:
        recomp = torch.isnan(u)
        mt_valid, _, u_mt, v_mt = intersect_tri(
            ray.origin, ray.direction, row[..., 0:3], row[..., 3:6], row[..., 6:9])
        keep = recomp & valid & mt_valid
        u = torch.where(recomp, torch.where(keep, u_mt, 0.0), u)
        v = torch.where(recomp, torch.where(keep, v_mt, 0.0), v)
    w = 1.0 - u - v
    # p = (1-u-v) p0 + u p1 + v p2 = v0 + u e1 + v e2
    p = row[..., 0:3] + u[..., None] * row[..., 3:6] + v[..., None] * row[..., 6:9]
    ng = row[..., 9:12]
    prim_area = row[..., 12]

    ns = fr.normalize(
        w[..., None] * row[..., 13:16]
        + u[..., None] * row[..., 16:19]
        + v[..., None] * row[..., 19:22]
    )
    # degenerate interpolated normals fall back to the geometric one
    ns = torch.where(
        (fr.length(ns) > 0.5)[..., None] & torch.isfinite(ns).all(dim=-1, keepdim=True),
        ns,
        ng,
    )
    # keep the shading normal in the geometric normal's hemisphere
    ns = torch.where((fr.dot(ns, ng) < 0.0)[..., None], -ns, ns)

    if needs_uv:
        uv = (
            w[..., None] * row[..., 22:24]
            + u[..., None] * row[..., 24:26]
            + v[..., None] * row[..., 26:28]
        )
    else:
        uv = torch.zeros_like(hit.bary)
    tangent = row[..., 28:31]
    inst = row[..., 31].to(torch.int32)

    density = row[..., 33]
    sph = arrays["trace"].get("sph")
    if sph is not None:
        p_tris = shade.shape[0]
        is_sph = hit.prim >= p_tris
        srow = sph[torch.clamp(hit.prim - p_tris, 0, sph.shape[0] - 1)]
        c = srow[..., 0:3]
        radius = srow[..., 3]
        rot = srow[..., 4:13]
        two_pi = 2.0 * np.pi
        phi = u * two_pi
        theta = v * np.pi
        st = torch.sin(theta)
        n_loc = (torch.cos(phi) * st, torch.sin(phi) * st, torch.cos(theta))
        # world normal = R n_loc (rot is row-major R)
        n_w = torch.stack([
            rot[..., 3 * r] * n_loc[0] + rot[..., 3 * r + 1] * n_loc[1]
            + rot[..., 3 * r + 2] * n_loc[2] for r in range(3)
        ], dim=-1)
        p_sph = c + radius[..., None] * n_w
        # dpdu = 2 pi r R (-sin phi st, cos phi st, 0); the frame's tangent at
        # the poles
        t_loc = (-torch.sin(phi) * st, torch.cos(phi) * st)
        t_w = torch.stack([
            rot[..., 3 * r] * t_loc[0] + rot[..., 3 * r + 1] * t_loc[1] for r in range(3)
        ], dim=-1) * (two_pi * radius)[..., None]
        t_w = torch.where((st > 1e-6)[..., None], t_w, fr.make_frame(n_w)["s"])
        m = is_sph[..., None]
        p = torch.where(m, p_sph, p)
        if needs_uv:
            uv = torch.where(m, hit.bary, uv)
        ng = torch.where(m, n_w, ng)
        ns = torch.where(m, n_w, ns)
        tangent = torch.where(m, t_w, tangent)
        inst = torch.where(is_sph, srow[..., 13].to(torch.int32), inst)
        prim_area = torch.where(is_sph, (4.0 * np.pi) * radius * radius, prim_area)
        valid = valid | (is_sph & (hit.prim < p_tris + sph.shape[0]))
        if cone_width is not None:
            density = torch.where(is_sph, 1.0 / torch.clamp(two_pi * radius, min=1e-20),
                                  density)
    footprint = None if cone_width is None else cone_width * density

    wo = -ray.direction
    back_facing = fr.dot(wo, ng) < 0.0
    return Interaction(
        valid=valid,
        inst=torch.where(valid, inst, -1),
        prim=hit.prim,
        p=p,
        ng=ng,
        ns=ns,
        tangent=tangent,
        uv=uv,
        prim_area=prim_area,
        back_facing=back_facing,
        footprint=footprint,
    )
