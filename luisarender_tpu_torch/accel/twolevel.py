"""Two-level acceleration: a TLAS over instances, one shared BLAS per mesh.

Counterpart of luisarender_tpu/accel/twolevel.py. A scene compiled with
`accel: "twolevel"` (or `auto` past the compiler's threshold) keeps each
unique mesh once, in object space, and places it by its instances'
transforms (scene/compiler.py `_build_two_level`), instead of flattening
every instance into one world-space tree.

Two traces over the same tables:

- `trace_closest_2l` / `trace_any_2l`, the plain version: the reference's
  TLAS/BLAS walk, one step a live lane an iteration. A lane is either in
  the TLAS (a Morton tree over instance boxes, one instance a leaf) or
  inside an instance's BLAS (the mesh's binary SAH tree, skip links local
  to the mesh). Entering a TLAS leaf moves the ray into the instance's
  object space without renormalizing the direction, so that t is shared
  between the spaces and hit ordering is global; leaving the BLAS resumes
  the TLAS at the saved skip node. No entry point on the card takes it;
  the tests and chip_smoke.py hold the composition against it.
- `trace_closest_2l_cluster` / `trace_any_2l_cluster`, the route on every
  device: one trace of ops/cluster.py a visible instance, over its mesh's
  cluster tables, with the rays in the instance's object space and the
  running best t as t_max, so that later instances prune against earlier
  hits; an equal t keeps the earlier instance. On CUDA tensors each is a
  launch of csrc/cluster.cu, queued with one shared error word that is
  read once a trace; on CPU tensors the cluster kernel's plain walk.

Instance row layout (INST_COLS wide, float32):
  0:12  world-to-object, row-major 3x4
  12:24 object-to-world, row-major 3x4 (scene/geometry.py rebuilds the
        world-space interaction with it)
  24    BLAS node offset     25 BLAS prim offset (the mesh's first row of
        the concatenated triangle and shade rows)
  26    opaque (blocks shadow rays)   27 visible

Hit.prim is the row of the concatenated object-space shade rows (the
mesh's own SAH slot plus its prim offset; the cluster tables carry it),
Hit.inst the instance.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.types import Hit
from ..ops import cluster
from ..ops.brute import mt_uvt

INST_COLS = 32
_BIG = 3.0e38


class TraceGeometry2L(NamedTuple):
    """The two-level tables on the device (scene/compiler.py builds them)."""

    # TLAS, preorder with skip links; a leaf holds one instance (-1: a
    # padded leaf). Leaves, padded ones included, are never descended: an
    # inverted padding box can pass the slab test where a zero direction
    # component makes its bounds +-inf
    tlas_aabb_min: torch.Tensor  # (Nt, 3)
    tlas_aabb_max: torch.Tensor  # (Nt, 3)
    tlas_skip: torch.Tensor  # (Nt,)
    tlas_inst: torch.Tensor  # (Nt,)
    tlas_leaf: torch.Tensor  # (Nt,) bool
    # every unique mesh's BLAS, concatenated (skip links local, -1 = leave)
    blas_aabb_min: torch.Tensor  # (Nb, 3)
    blas_aabb_max: torch.Tensor  # (Nb, 3)
    blas_skip: torch.Tensor  # (Nb,)
    blas_first: torch.Tensor  # (Nb,) a leaf's first mesh-local slot, -1
    blas_count: torch.Tensor  # (Nb,)
    # object-space triangles in each mesh's SAH order, concatenated
    tri_v0: torch.Tensor  # (P, 3)
    tri_e1: torch.Tensor  # (P, 3)
    tri_e2: torch.Tensor  # (P, 3)
    tri_valid: torch.Tensor  # (P,) bool
    inst_rows: torch.Tensor  # (I, INST_COLS) float32, the layout above
    leaf_size: int
    # the composition's tables: ((cluster nodes, cluster blocks), ...) a
    # unique mesh, shared by its instances, and the instances' static
    # routing (python values)
    cluster_sets: tuple = ()
    inst_mesh: tuple = ()  # instance -> unique mesh
    inst_opaque: tuple = ()  # the instance blocks shadow rays
    inst_visible: tuple = ()  # the instance is seen by the traces


def _xform_point(row, base, p):
    """The 3x4 at `base` of rows (INST_COLS,) or (N, INST_COLS) applied to
    points (N, 3): m0 x + m1 y + m2 z + m3 a row, added left to right, as
    in the reference."""
    m = row[..., base:base + 12].unflatten(-1, (3, 4))
    return (m[..., 0] * p[:, 0:1] + m[..., 1] * p[:, 1:2] + m[..., 2] * p[:, 2:3]
            + m[..., 3])


def _xform_vector(row, base, v):
    m = row[..., base:base + 12].unflatten(-1, (3, 4))
    return m[..., 0] * v[:, 0:1] + m[..., 1] * v[:, 1:2] + m[..., 2] * v[:, 2:3]


def _xform_normal(row, base, n):
    """Normals by the transpose of the 3x3 at `base`: at the world-to-object
    transform's base, the object-to-world inverse transpose."""
    m = row[..., base:base + 12].unflatten(-1, (3, 4))
    return m[..., 0, :3] * n[:, 0:1] + m[..., 1, :3] * n[:, 1:2] + m[..., 2, :3] * n[:, 2:3]


def _slab(o, inv_d, t_min, t_max, bmin, bmax):
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = torch.maximum(torch.minimum(t0, t1).amax(dim=-1), t_min)
    far = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), t_max)
    return near <= far


def _intersect(o, d, v0, e1, e2):
    big_det, inside, t, u, v = mt_uvt(*v0.unbind(-1), *e1.unbind(-1), *e2.unbind(-1),
                                      *o.unbind(-1), *d.unbind(-1))
    return big_det & inside, t, u, v


def trace_closest_2l(geom: TraceGeometry2L, rays, shadow: bool = False) -> Hit:
    """Closest hit through the TLAS and the BLASes (the plain version).
    shadow=True skips instances that do not block shadow rays."""
    o_w, d_w = rays.origin, rays.direction
    n, dev = o_w.shape[0], o_w.device
    inv_w = cluster.safe_inv(d_w)
    i64 = dict(dtype=torch.int64, device=dev)
    tlas = torch.zeros(n, **i64)  # the TLAS node (-1: done)
    blas = torch.full((n,), -1, **i64)  # the BLAS node (-1: in the TLAS)
    inst = torch.full((n,), -1, **i64)
    prim_off = torch.zeros(n, **i64)
    node_off = torch.zeros(n, **i64)
    o, d, inv = o_w.clone(), d_w.clone(), inv_w.clone()
    best_t = torch.clamp(rays.t_max, max=_BIG).clone()
    best_inst = torch.full((n,), -1, **i64)
    best_prim = torch.full((n,), -1, **i64)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    n_tri = geom.tri_v0.shape[0]
    # each step moves a lane forward in a preorder: at most every TLAS node
    # and, for every instance it enters, every node of the BLAS
    max_steps = geom.tlas_skip.shape[0] * (1 + geom.blas_skip.shape[0]) + 1

    lanes = torch.arange(n, device=dev)
    for _ in range(max_steps):
        if lanes.numel() == 0:
            break
        ow, iw, tmin, t_cur = o_w[lanes], inv_w[lanes], rays.t_min[lanes], best_t[lanes]
        tl, bl = tlas[lanes], blas[lanes]
        # ---- the TLAS step (lanes not inside a BLAS) ----
        tnode = torch.clamp(tl, min=0)
        t_active = (bl < 0) & (tl >= 0)
        t_hit = t_active & _slab(ow, iw, tmin, t_cur, geom.tlas_aabb_min[tnode],
                                 geom.tlas_aabb_max[tnode])
        inst_at = geom.tlas_inst[tnode].long()
        is_leaf = geom.tlas_leaf[tnode]
        irow = geom.inst_rows[torch.clamp(inst_at, min=0)]
        enter = t_hit & is_leaf & (inst_at >= 0) & (irow[:, 27] > 0.0)
        if shadow:
            enter = enter & (irow[:, 26] > 0.0)
        next_tlas = torch.where(t_hit & ~is_leaf, tnode + 1,
                                torch.where(t_active, geom.tlas_skip[tnode].long(), tl))
        # entering lanes: the object-space ray, its direction not renormalized
        d_obj = _xform_vector(irow, 0, d_w[lanes])
        e3 = enter[:, None]
        o_l = torch.where(e3, _xform_point(irow, 0, ow), o[lanes])
        d_l = torch.where(e3, d_obj, d[lanes])
        inv_l = torch.where(e3, cluster.safe_inv(d_obj), inv[lanes])
        blas_off = irow[:, 24].long()
        bl = torch.where(enter, blas_off, bl)
        inst_l = torch.where(enter, inst_at, inst[lanes])
        poff = torch.where(enter, irow[:, 25].long(), prim_off[lanes])
        noff = torch.where(enter, blas_off, node_off[lanes])
        tl = torch.where(t_active, next_tlas, tl)

        # ---- the BLAS step (lanes inside a BLAS, just entered included) ----
        b_active = bl >= 0
        bnode = torch.clamp(bl, min=0)
        b_hit = b_active & _slab(o_l, inv_l, tmin, t_cur, geom.blas_aabb_min[bnode],
                                 geom.blas_aabb_max[bnode])
        cnt = geom.blas_count[bnode].long()
        b_leaf = cnt > 0
        do_leaf = b_hit & b_leaf
        base = torch.clamp(geom.blas_first[bnode].long(), min=0) + poff
        bt, bi, bp = t_cur, best_inst[lanes], best_prim[lanes]
        bu, bv = best_u[lanes], best_v[lanes]
        for j in range(geom.leaf_size):
            pidx = torch.clamp(base + j, max=n_tri - 1)
            ok, t, u, v = _intersect(o_l, d_l, geom.tri_v0[pidx], geom.tri_e1[pidx],
                                     geom.tri_e2[pidx])
            ok = ok & do_leaf & (j < cnt) & geom.tri_valid[pidx] & (t > tmin) & (t < bt)
            bt = torch.where(ok, t, bt)
            bp = torch.where(ok, pidx, bp)
            bi = torch.where(ok, inst_l, bi)
            bu = torch.where(ok, u, bu)
            bv = torch.where(ok, v, bv)
        next_local = torch.where(b_hit & ~b_leaf, bnode - noff + 1,
                                 geom.blas_skip[bnode].long())
        bl = torch.where(b_active, torch.where(next_local < 0, -1, next_local + noff), bl)

        tlas[lanes], blas[lanes], inst[lanes] = tl, bl, inst_l
        prim_off[lanes], node_off[lanes] = poff, noff
        o[lanes], d[lanes], inv[lanes] = o_l, d_l, inv_l
        best_t[lanes], best_inst[lanes], best_prim[lanes] = bt, bi, bp
        best_u[lanes], best_v[lanes] = bu, bv
        lanes = lanes[(tl >= 0) | (bl >= 0)]
    else:
        raise RuntimeError(f"trace_closest_2l: more than {max_steps} steps: malformed tables")

    found = best_prim >= 0
    return Hit(
        inst=torch.where(found, best_inst, -1).to(torch.int32),
        prim=best_prim.to(torch.int32),
        bary=torch.stack([best_u, best_v], dim=-1),
        t=torch.where(found, best_t, math.inf),
    )


def trace_any_2l(geom: TraceGeometry2L, rays):
    """Occlusion by the instances that block shadow rays (the plain
    version)."""
    return trace_closest_2l(geom, rays, shadow=True).prim >= 0


# ---------------------------------------------------------------------------
# the composition: a cluster trace an instance, over the mesh's shared tables
# ---------------------------------------------------------------------------


def _inst_ray(geom, i, rays):
    """The rays in instance i's object space (direction not renormalized)."""
    row = geom.inst_rows[i]
    return _xform_point(row, 0, rays.origin), _xform_vector(row, 0, rays.direction)


def _require_cluster_sets(geom):
    if not geom.cluster_sets or len(geom.inst_mesh) != geom.inst_rows.shape[0]:
        raise ValueError("a two-level trace needs the per-mesh cluster tables and every "
                         "instance's mesh (scene/compiler.py _build_two_level builds them)")


def trace_closest_2l_cluster(geom: TraceGeometry2L, rays) -> Hit:
    """Closest hit: the cluster trace of each visible instance in instance
    order, the best t so far as its t_max; a hit replaces the best only
    where its t is less, so an equal t keeps the earlier instance. Every
    launch sets its error bits in one shared word, read once, after the
    last launch (ops/cluster.py check_error)."""
    _require_cluster_sets(geom)
    n, dev = rays.origin.shape[0], rays.origin.device
    t_min = rays.t_min.contiguous()
    best_t = torch.clamp(rays.t_max, max=_BIG).contiguous()
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    word = torch.zeros((1,), dtype=torch.int32, device=dev)
    for i, mesh_i in enumerate(geom.inst_mesh):
        if not geom.inst_visible[i]:
            continue
        o, d = _inst_ray(geom, i, rays)
        nodes, tris = geom.cluster_sets[mesh_i]
        t, slot, u, v = cluster.closest(o, d, t_min, best_t, nodes, tris, word)
        ok = (slot >= 0) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_prim = torch.where(ok, slot, best_prim)
        best_inst = torch.where(ok, i, best_inst)
        best_u = torch.where(ok, u, best_u)
        best_v = torch.where(ok, v, best_v)
    cluster.check_error(word, any_hit=False)
    found = best_prim >= 0
    return Hit(
        inst=torch.where(found, best_inst, -1),
        prim=best_prim,
        bary=torch.stack([best_u, best_v], dim=-1),
        t=torch.where(found, best_t, math.inf),
    )


def trace_any_2l_cluster(geom: TraceGeometry2L, rays):
    """Occlusion: the any-hit trace of each visible instance that blocks
    shadow rays; lanes already occluded get t_max = 0 for the later ones.
    One error word for every launch, read once, as trace_closest_2l_cluster
    does."""
    _require_cluster_sets(geom)
    n, dev = rays.origin.shape[0], rays.origin.device
    t_min = rays.t_min.contiguous()
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    word = torch.zeros((1,), dtype=torch.int32, device=dev)
    for i, mesh_i in enumerate(geom.inst_mesh):
        if not (geom.inst_visible[i] and geom.inst_opaque[i]):
            continue
        o, d = _inst_ray(geom, i, rays)
        nodes, tris = geom.cluster_sets[mesh_i]
        t_max = torch.where(occ, 0.0, rays.t_max).contiguous()
        occ = occ | cluster.any_hit(o, d, t_min, t_max, nodes, tris, word)
    cluster.check_error(word, any_hit=True)
    return occ
