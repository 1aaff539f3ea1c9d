"""Closest-hit / any-hit ray traversal of a SAH tree of triangle clusters,
for scenes above the brute-force size.

Counterpart of luisarender_tpu/ops/cluster_pallas.py. `build_cluster_tables`
builds the reference's tables (its default: one SAH leaf of at most 128
triangles a block, no packing):

- node table (N, 8) float32: 0:3 box min, 3:6 box max, 6 right child with
  the near-child hint in its fraction (+axis/4, +1/16 when the left child
  lies on the high side of that axis; -1 on leaves), 7 the leaf's cluster id
  (-1 on interior nodes). Node i's left child is i + 1 (preorder). Rows are
  padded with empty boxes to a multiple of 128.
- triangle blocks (C, 16, 128) float32, attribute-major: row j of block c
  has v0 / e1 / e2 in attributes 0-8, 9 valid (0 = padding), 10 opaque,
  11 the triangle's slot in the scene's SAH order (the row of the shade
  table that a hit indexes).

On CUDA tensors `closest` / `any_hit` launch the hand-written kernel of
csrc/cluster.cu (a lane a ray, each warp testing its lanes' leaves
together; the source says why). On CPU tensors they run the plain PyTorch
versions below, which walk the same tree with the same per-lane order and
arithmetic. There is no fallback: a CUDA tensor launches the kernel or
raises. A malformed tree (a stack deeper than STACK_DEPTH, more than
4 N + 64 pops for a ray, a child or cluster index out of range) raises in
both. `closest` and `any_hit` are torch.autograd.Functions that pass no
gradient (ops/nograd.py), as the reference's custom VJP passes zeros.

The reference's wrapper sorts launches of at least 32,768 rays
(cluster_pallas.py MIN_SORT_RAYS) into coherent packets first.
`coherence_order` is that order (the reference's `_coherence_keys`, origin
cell major, direction cell minor, dead rays last). Each ray's walk is its
own, so the outputs are the same in either order; on the H100 the kernel
is slower on sorted closest-hit rays and gains at most 12 us on sorted
shadow rays of the mesh-heavy scene, before the sort's own cost
(PERF.md), so `closest` / `any_hit` launch in caller order at every size.

`closest_launches` / `any_launches` count kernel launches, so that a run can
show its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .brute import mt_uvt
from .nograd import no_grad_entry

CLUSTER = 128  # triangles a leaf block
TRI_COLS = 16
NODE_COLS = 8
STACK_DEPTH = 64
_BIG = 3.0e38
# the kernel's optional per-launch counters (csrc/cluster.cu CTR_*)
COUNTERS = ("rounds", "parked", "loads", "rows", "row_slots", "pops", "pop_slots")
# lanes whose leaf blocks are gathered at once by the plain version:
# (LEAF_CHUNK, 12, 128) float32 is 100 MB
LEAF_CHUNK = 16384

ERR_STACK, ERR_STEPS, ERR_INDEX = 1, 2, 4
_ERRORS = {ERR_STACK: f"a traversal stack deeper than {STACK_DEPTH}",
           ERR_STEPS: "more than 4 N + 64 node pops for a ray",
           ERR_INDEX: "a child or cluster index out of range"}

closest_launches = 0
any_launches = 0


# ---------------------------------------------------------------------------
# host-side tables
# ---------------------------------------------------------------------------


def build_cluster_tables(positions, triangles, opaque_orig, canon_of_orig):
    """(node table (N, 8), triangle blocks (C, 16, 128)) float32 numpy arrays.

    positions (V, 3); triangles (T, 3); opaque_orig (T,) bool, per original
    triangle; canon_of_orig (T,) the slot in the scene's SAH order of each
    original triangle."""
    from ..accel.native import build_bvh_sah

    positions = np.asarray(positions, np.float32)
    triangles = np.asarray(triangles, np.int32)
    bvh = build_bvh_sah(positions, triangles, leaf_size=CLUSTER)

    # one block a SAH leaf, in preorder
    clusters = []
    for nid in np.nonzero(bvh.node_count > 0)[0]:
        f = int(bvh.node_first[nid])
        ids = bvh.prim_index[f:f + int(bvh.node_count[nid])]
        ids = ids[ids >= 0]
        if ids.size:
            clusters.append(ids)
    order = np.full((len(clusters), CLUSTER), -1, np.int32)
    for bi, ids in enumerate(clusters):
        order[bi, :ids.size] = ids
    order = order.reshape(-1)
    p = order.shape[0]
    valid = order >= 0
    safe = np.where(valid, order, 0)

    v0 = positions[triangles[safe, 0]]
    v1 = positions[triangles[safe, 1]]
    v2 = positions[triangles[safe, 2]]
    tri = np.zeros((p, TRI_COLS), np.float32)
    tri[:, 0:3] = v0
    tri[:, 3:6] = v1 - v0
    tri[:, 6:9] = v2 - v0
    tri[:, 9] = valid.astype(np.float32)
    tri[:, 10] = np.where(valid, np.asarray(opaque_orig)[safe], False).astype(np.float32)
    tri[:, 11] = np.where(valid, np.asarray(canon_of_orig, np.int64)[safe], -1).astype(np.float32)
    tri = np.ascontiguousarray(tri.reshape(p // CLUSTER, CLUSTER, TRI_COLS).transpose(0, 2, 1))

    # coarse tree: SAH over one degenerate triangle per cluster whose AABB
    # is the cluster's bounds (the builder looks only at primitive AABBs)
    vmin = np.minimum(np.minimum(v0, v1), v2)
    vmax = np.maximum(np.maximum(v0, v1), v2)
    big = np.float32(_BIG)
    vmin = np.where(valid[:, None], vmin, big).reshape(-1, CLUSTER, 3).min(1)
    vmax = np.where(valid[:, None], vmax, -big).reshape(-1, CLUSTER, 3).max(1)
    ncl = vmin.shape[0]
    bverts = np.empty((3 * ncl, 3), np.float32)
    bverts[0::3] = vmin
    bverts[1::3] = vmax
    bverts[2::3] = np.stack([vmin[:, 0], vmax[:, 1], vmin[:, 2]], axis=-1)
    btris = np.arange(3 * ncl, dtype=np.int32).reshape(ncl, 3)
    cb = build_bvh_sah(bverts, btris, leaf_size=1)

    n = cb.aabb_min.shape[0]
    node = np.zeros((n, NODE_COLS), np.float32)
    node[:, 0:3] = cb.aabb_min
    node[:, 3:6] = cb.aabb_max
    # interior: col 6 = right child = skip[node + 1] (the left child's skip
    # link points past the left subtree), plus the near-child hint in the
    # fraction while it is exact in float32 (right < 2^20); leaf: -1
    is_leaf = cb.node_count > 0
    right = np.full(n, -1.0, np.float32)
    interior = np.nonzero(~is_leaf)[0]
    if interior.size:
        right_i = cb.skip[interior + 1]
        right[interior] = right_i
        if n < (1 << 20):
            left_i = interior + 1
            c_l = 0.5 * (cb.aabb_min[left_i] + cb.aabb_max[left_i])
            c_r = 0.5 * (cb.aabb_min[right_i] + cb.aabb_max[right_i])
            sep = c_r - c_l
            axis = np.argmax(np.abs(sep), axis=-1)
            left_high = np.take_along_axis(sep, axis[:, None], axis=-1)[:, 0] < 0.0
            right[interior] += axis * 0.25 + left_high * 0.0625
    node[:, 6] = right
    leaf_pid = np.full(n, -1, np.int64)
    lf = np.nonzero(is_leaf)[0]
    if lf.size:
        leaf_pid[lf] = cb.prim_index[cb.node_first[lf]]
    node[:, 7] = leaf_pid.astype(np.float32)
    n_pad = (-n) % 128
    if n_pad:
        pad_rows = np.zeros((n_pad, NODE_COLS), np.float32)
        pad_rows[:, 0:3] = _BIG
        pad_rows[:, 3:6] = -_BIG
        pad_rows[:, 6] = -1.0
        pad_rows[:, 7] = -1.0
        node = np.concatenate([node, pad_rows], axis=0)
    assert p < (1 << 24) and node.shape[0] < (1 << 24)
    return node, tri


def stack_need(children) -> int:
    """Entries a one-pop depth-first walk's stack can hold at most over a
    tree whose node i, when popped, pushes the children `children[i]` ((N,
    K) node indices, -1 for none): 1 + the largest sum, over the paths from
    the root, of each node's pushes less one (the popped node itself), every
    child taken. Each node of a tree is pushed at most once, so this is at
    most N. Children out of range are left out (the walks raise on them);
    the sums are followed for at most N levels, so a loop, which the walks
    stop by their pop cap, ends it too."""
    ch = np.asarray(children, np.int64)
    n = ch.shape[0]
    ok = (ch >= 0) & (ch < n)
    pushes = ok.sum(axis=1)
    level, held = np.zeros(1, np.int64), pushes[:1]  # held: after the pushes
    need = 1
    for _ in range(n):
        if level.size == 0:
            break
        need = max(need, int(held.max()))
        kids = ch[level][ok[level]]
        best = np.full(n, -1, np.int64)
        np.maximum.at(best, kids, np.repeat(held - 1, ok[level].sum(axis=1)) + pushes[kids])
        level = np.unique(kids)
        held = best[level]
    return need


# ---------------------------------------------------------------------------
# plain PyTorch version: a batched walk with a stack per lane, one pop per
# live lane an iteration, in the kernel's per-lane order and arithmetic
# ---------------------------------------------------------------------------


def safe_inv(v):
    tiny = 1e-12
    return 1.0 / torch.where(torch.abs(v) < tiny, torch.where(v < 0, -tiny, tiny), v)


def slab(row, ox, oy, oz, ix, iy, iz, t_min, t_far):
    """Node rows (k, 8) against k rays; NaN-ignoring min / max, as the
    kernel's fminf / fmaxf."""
    near, far = slab_range(row, ox, oy, oz, ix, iy, iz, t_min, t_far)
    return near <= far


def slab_range(row, ox, oy, oz, ix, iy, iz, t_min, t_far):
    """(near, far) of the slab test of boxes (k, 6+: min xyz, max xyz)
    against k rays: the box is hit where near <= far (csrc/trace_common.cuh
    slab_near)."""
    t0x = (row[:, 0] - ox) * ix
    t1x = (row[:, 3] - ox) * ix
    t0y = (row[:, 1] - oy) * iy
    t1y = (row[:, 4] - oy) * iy
    t0z = (row[:, 2] - oz) * iz
    t1z = (row[:, 5] - oz) * iz
    near = torch.fmax(torch.fmax(torch.fmin(t0x, t1x), torch.fmin(t0y, t1y)),
                      torch.fmax(torch.fmin(t0z, t1z), t_min))
    far = torch.fmin(torch.fmin(torch.fmax(t0x, t1x), torch.fmax(t0y, t1y)),
                     torch.fmin(torch.fmax(t0z, t1z), t_far))
    return near, far


def _leaf_tests(blk, ox, oy, oz, dx, dy, dz, t_min, best_t, any_hit):
    """Every row of k leaf blocks (k, 12, 128) against k rays ((k, 1)
    each): (ok (k, 128), t, u, v), Moller-Trumbore in the kernel's order."""
    attrs = blk.unbind(1)  # v0 / e1 / e2, valid, opaque, slot
    _, inside, t, u, v = mt_uvt(*attrs[:9], ox, oy, oz, dx, dy, dz)
    ok = inside & (attrs[9] > 0.0) & (t > t_min) & (t < best_t)
    if any_hit:
        ok = ok & (attrs[10] > 0.0)
    return ok, t, u, v


def leaf_blocks_plain(blk12, lanes, blks, ray, best, stats, any_hit):
    """Every row of the leaf blocks `blks` ((k,) ids into blk12, the
    (C, 12, 128) attributes 0-11 of the triangle blocks) against the rays
    `lanes` (k,), LEAF_CHUNK lanes at a time, as a kernel tests a leaf.
    `ray` = (ox, oy, oz, dx, dy, dz, t_min) of every ray. Closest: the first
    row of least t updates best = (best_t, best_s, best_u, best_v) in place
    (the kernel's in-order strict t < best_t). Any-hit: returns the lanes
    that found an occluder (the kernel stops at the first). Adds a leaf
    visit and the valid rows tested to stats (N, 3) columns 1 and 2."""
    ox, oy, oz, dx, dy, dz, t_min = ray
    best_t, best_s, best_u, best_v = best
    occluded = [lanes[:0]]
    for c in range(0, lanes.numel(), LEAF_CHUNK):
        lc, fc = lanes[c:c + LEAF_CHUNK], blks[c:c + LEAF_CHUNK]
        blk = blk12[fc]
        ok, t, u, v = _leaf_tests(
            blk, ox[lc, None], oy[lc, None], oz[lc, None], dx[lc, None],
            dy[lc, None], dz[lc, None], t_min[lc, None], best_t[lc, None], any_hit)
        valid = blk[:, 9, :] > 0.0
        stats[lc, 1] += 1
        found = ok.any(dim=1)
        if any_hit:
            j = torch.argmax(ok.to(torch.int32), dim=1)
            upto = torch.arange(CLUSTER, device=t.device)[None, :] <= j[:, None]
            tested = torch.where(found[:, None], valid & upto, valid)
            stats[lc, 2] += tested.sum(dim=1).to(torch.int32)
            occluded.append(lc[found])
            continue
        stats[lc, 2] += valid.sum(dim=1).to(torch.int32)
        j = torch.argmin(torch.where(ok, t, math.inf), dim=1, keepdim=True)
        fl = lc[found]
        best_t[fl] = t.gather(1, j)[found, 0]
        best_u[fl] = u.gather(1, j)[found, 0]
        best_v[fl] = v.gather(1, j)[found, 0]
        best_s[fl] = blk[:, 11, :].gather(1, j)[found, 0].to(torch.int32)
    return torch.cat(occluded)


def _spread(x):
    """Every third bit of a 10-bit int64 (Morton part1by2)."""
    x = (x | (x << 16)) & 0xFF0000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def _morton(q):
    return _spread(q[:, 0]) | (_spread(q[:, 1]) << 1) | (_spread(q[:, 2]) << 2)


def coherence_keys(o, d, t_min, t_max, lo, ext):
    """The reference's sort keys (cluster_pallas.py _coherence_keys, mode 0),
    bit for bit: the origin's 6-bit cell a dimension in the box (lo, lo +
    ext), Morton-interleaved, major; the direction's 4-bit cell over [-1, 1]
    minor; 0x40000000 for dead rays (t_max <= t_min). float32 arithmetic in
    the reference's order; int64 keys (torch's CPU uint32 has no shifts)."""
    ext = torch.clamp_min(ext, 1e-12)
    qo = torch.clamp((o - lo) / ext * 63.0, 0.0, 63.0).to(torch.int64)
    qd = torch.clamp((d * 0.5 + 0.5) * 15.0, 0.0, 15.0).to(torch.int64)
    key = (_morton(qo) << 12) | _morton(qd)
    return torch.where(t_max <= t_min, 0x40000000, key)


def coherence_order(o, d, t_min, t_max, nodes):
    """The rays' order by coherence_keys over the root box of the node table
    (stable: rays of one key keep caller order), as int64 indices."""
    lo = nodes[0, 0:3]
    key = coherence_keys(o, d, t_min, t_max, lo, nodes[0, 3:6] - lo)
    return torch.sort(key.to(torch.int32), stable=True).indices


def _raise(err, name):
    msgs = [m for bit, m in _ERRORS.items() if err & bit]
    raise RuntimeError(f"{name}: malformed cluster tree: {', '.join(msgs)}")


def walk_plain(o, d, t_min, t_max, nodes, tris, any_hit, visited=None):
    """The plain version of both kernel modes. Returns (t (inf on miss),
    slot (-1), u, v, occluded (bool), stats (N, 3) int32: node pops, leaf
    visits and valid triangle rows tested per ray). `visited`, when given,
    is a (C,) bool tensor in which the walk marks every cluster some ray
    tested."""
    name = "cluster_any" if any_hit else "cluster_closest"
    n, dev = o.shape[0], o.device
    n_nodes, n_clusters = nodes.shape[0], tris.shape[0]
    max_steps = 4 * n_nodes + 64
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    best_t = torch.where(t_max < _BIG, t_max, _BIG)
    best_s = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    stats = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = (t_min < best_t).to(torch.int64)  # the root, on lanes live on entry
    blk12 = tris[:, :12, :]

    lanes = torch.nonzero(sp > 0).squeeze(1)
    while lanes.numel():
        if bool((stats[lanes, 0] >= max_steps).any()):
            _raise(ERR_STEPS, name)
        sp[lanes] -= 1
        node = stack[lanes, sp[lanes]].long()
        stats[lanes, 0] += 1
        row = nodes[node]
        hit = slab(row, ox[lanes], oy[lanes], oz[lanes], ix[lanes], iy[lanes],
                   iz[lanes], t_min[lanes], best_t[lanes])
        c6 = row[:, 6]
        rf = torch.floor(c6)
        first = row[:, 7].to(torch.int32)
        is_leaf = first >= 0

        inner = hit & ~is_leaf
        il = lanes[inner]
        if il.numel():
            right = rf[inner].to(torch.int64)
            left = node[inner] + 1
            if bool(((right < 0) | (right >= n_nodes) | (left >= n_nodes)).any()):
                _raise(ERR_INDEX, name)
            if bool((sp[il] + 2 > STACK_DEPTH).any()):
                _raise(ERR_STACK, name)
            frac4 = (c6[inner] - rf[inner]) * 4.0
            axf = torch.floor(frac4 + 0.25)
            left_high = (frac4 - axf) > 0.125
            axis = axf.to(torch.int64)
            dax = torch.where(axis == 0, dx[il], torch.where(axis == 1, dy[il], dz[il]))
            left_near = (dax >= 0.0) != left_high
            top = sp[il]
            stack[il, top] = torch.where(left_near, right, left).to(torch.int32)
            stack[il, top + 1] = torch.where(left_near, left, right).to(torch.int32)
            sp[il] = top + 2

        leaf = hit & is_leaf
        ll, lfirst = lanes[leaf], first[leaf].long()
        if ll.numel() and bool((lfirst >= n_clusters).any()):
            _raise(ERR_INDEX, name)
        if visited is not None:
            visited[lfirst] = True
        hit_l = leaf_blocks_plain(blk12, ll, lfirst, (ox, oy, oz, dx, dy, dz, t_min),
                                 (best_t, best_s, best_u, best_v), stats, any_hit)
        occ[hit_l] = True
        sp[hit_l] = 0  # an occluded ray leaves the walk
        lanes = torch.nonzero(sp > 0).squeeze(1)

    found = best_s >= 0
    return (torch.where(found, best_t, math.inf), best_s, best_u, best_v, occ, stats)


def closest_plain(o, d, t_min, t_max, nodes, tris):
    """Plain version of the closest-hit kernel: (t, slot, u, v)."""
    return walk_plain(o, d, t_min, t_max, nodes, tris, False)[:4]


def any_plain(o, d, t_min, t_max, nodes, tris):
    """Plain version of the any-hit kernel: bool occlusion per ray."""
    return walk_plain(o, d, t_min, t_max, nodes, tris, True)[4]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


_LIB = None


def _library():
    """The built kernel library, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("cluster")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        args = [ptr] * 5 + [i32, ptr, i32, i32]
        # outputs, stats, counters and the error word; device and stream
        lib.cluster_closest.argtypes = args + [ptr] * 7 + [i32, ptr]
        lib.cluster_closest.restype = i32
        lib.cluster_any.argtypes = args + [ptr] * 4 + [i32, ptr]
        lib.cluster_any.restype = i32
        lib.cluster_counters.restype = i32
        if lib.cluster_counters() != len(COUNTERS):
            raise RuntimeError(f"csrc/cluster.cu keeps {lib.cluster_counters()} counters, "
                               f"ops/cluster.py names {len(COUNTERS)}")
        _LIB = lib
    return _LIB


def _check(o, d, t_min, t_max, nodes, tris):
    dev = o.device
    n = o.shape[0]
    for name, x, shape in (
        ("origin", o, (n, 3)), ("direction", d, (n, 3)),
        ("t_min", t_min, (n,)), ("t_max", t_max, (n,)),
        ("nodes", nodes, (nodes.shape[0], NODE_COLS)),
        ("tris", tris, (tris.shape[0], TRI_COLS, CLUSTER)),
    ):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, origin on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nodes.shape[0] == 0 or nodes.shape[0] >= (1 << 24) or tris.shape[0] >= (1 << 17):
        raise ValueError(f"{nodes.shape[0]} node rows / {tris.shape[0]} clusters: "
                         "node rows must be 1 to 2^24 - 1, clusters below 2^17")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and nodes.data_ptr() % 16:
        raise ValueError("the node table must be 16-byte aligned (float4 loads)")


def launch(o, d, t_min, t_max, nodes, tris, any_hit, err, stats=None, counters=None):
    """Queue one kernel launch on the current stream and return its outputs
    without waiting: closest (t, slot, u, v) or any-hit occlusion (int32).
    The rays are walked in the order given. Errors of the walk are OR-ed
    into `err` (an int32 tensor of one element on the card); `closest` /
    `any_hit` read it. `stats`, when given, is an (N, 3) int32 tensor that
    receives pops, leaf visits and rows tested per ray; `counters`, a
    contiguous int64 tensor of len(COUNTERS) that the kernel adds its lane
    counters to."""
    global closest_launches, any_launches
    n = o.shape[0]
    dev = o.device
    if counters is not None and (counters.device != dev or counters.dtype != torch.int64
                                 or counters.shape != (len(COUNTERS),)
                                 or not counters.is_contiguous()):
        raise ValueError(f"counters must be a contiguous int64 ({len(COUNTERS)},) "
                         f"tensor on {dev}")
    lib = _library()
    common = (o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
              nodes.data_ptr(), nodes.shape[0], tris.data_ptr(), tris.shape[0], n)
    tail = (0 if stats is None else stats.data_ptr(),
            0 if counters is None else counters.data_ptr(), err.data_ptr(), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    if any_hit:
        occ = torch.empty((n,), dtype=torch.int32, device=dev)
        rc = lib.cluster_any(*common, occ.data_ptr(), *tail)
        out = occ
    else:
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        slot = torch.empty((n,), dtype=torch.int32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        rc = lib.cluster_closest(*common, t.data_ptr(), slot.data_ptr(), u.data_ptr(),
                                 v.data_ptr(), *tail)
        out = (t, slot, u, v)
    if rc != 0:
        raise RuntimeError(f"cluster kernel launch failed: CUDA error {rc}")
    if any_hit:
        any_launches += 1
    else:
        closest_launches += 1
    return out


def check_error(err, any_hit):
    """Read the error word of launches queued with it (waits for them) and
    raise on a malformed tree. A CPU word is never set: the plain version
    raises at once."""
    if err.device.type == "cpu":
        return
    code = int(err.item())
    if code:
        _raise(code, "cluster_any" if any_hit else "cluster_closest")


def _run(o, d, t_min, t_max, nodes, tris, any_hit, err):
    """Launch, and read the error word unless the caller passed its own,
    which it reads once after all its launches (check_error)."""
    own = err is None
    if own:
        err = torch.zeros((1,), dtype=torch.int32, device=o.device)
    elif err.device != o.device or err.dtype != torch.int32 or err.shape != (1,):
        raise ValueError(f"err must be an int32 (1,) tensor on {o.device}")
    out = launch(o, d, t_min, t_max, nodes, tris, any_hit, err)
    if own:
        check_error(err, any_hit)
    return out


@no_grad_entry
def closest(o, d, t_min, t_max, nodes, tris, err=None):
    """Closest hit of each ray: (t (inf on miss), slot (-1 on miss), u, v),
    slot = the triangle's row in the scene's SAH order. `err`, an int32
    tensor of one element on the card, makes the launch one of several
    whose errors the caller reads once (check_error)."""
    _check(o, d, t_min, t_max, nodes, tris)
    if o.device.type == "cpu":
        return closest_plain(o, d, t_min, t_max, nodes, tris)
    if o.shape[0] == 0:
        e = o.new_empty((0,))
        return e, torch.empty((0,), dtype=torch.int32, device=o.device), e, e
    return _run(o, d, t_min, t_max, nodes, tris, False, err)


@no_grad_entry
def any_hit(o, d, t_min, t_max, nodes, tris, err=None):
    """Occlusion of each ray by any valid opaque triangle within
    (t_min, t_max); `err` as for closest."""
    _check(o, d, t_min, t_max, nodes, tris)
    if o.device.type == "cpu":
        return any_plain(o, d, t_min, t_max, nodes, tris)
    if o.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=o.device)
    return _run(o, d, t_min, t_max, nodes, tris, True, err) > 0
