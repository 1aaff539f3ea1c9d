"""Closest-hit traversal of the scene's binary SAH tree, a few triangles a
leaf.

Counterpart of luisarender_tpu/ops/trace_pallas.py (`pack_tables`,
`trace_closest_pallas`). As in the reference, no router reaches it: it is
an entry point of its own over the binary tree the scene compiler keeps,
which `pack_tables` reads from a compiled scene's TraceGeometry
(`aabb_min`, `aabb_max`, `skip`, `node_first`, `node_count`, `leaf_size`
and the SAH-ordered triangle rows).

- node table (N, 16) float32: 0:3 box min, 3:6 box max, 6 skip link, 7 the
  leaf's triangle count (0 on interior nodes), 8 its first row. Node i's
  left child is i + 1 (preorder); its right child is skip[i + 1].
- triangle table (P, 16) float32: 0:3 v0, 3:6 e1, 6:9 e2, 9 the row's
  original triangle (prim_index, -1 for padding).
- child-pair table (1 + I, 16) float32, derived from the node table once a
  tree (`build_pairs`) and walked by both versions below: row 0 holds the
  root, row 1 + k the k-th interior node in preorder; a row holds both
  children's boxes and codes (see `build_pairs`).

The walk visits pair rows, each testing both children's boxes against the
ray's best t, goes on to child 0 when it is hit and pushes child 1 with
its entry t when both are; a popped entry whose entry t lies past the best
t is dropped, which is the reference's slab test of its box at that pop.
So it meets the boxes in the reference's order (left child first) and
keeps, as the reference does, the first hit of least t (a strict t <
best_t, a leaf's rows in order). A nearer-child-first order would not
give that answer on every ray (tests/test_torch_trace.py face_tie_tree).
`stats` counts, per ray, the pair rows visited (row 0 included), the
leaves entered and the rows tested.

On CUDA tensors `closest` launches csrc/trace.cu (a lane a ray walking to
a leaf, each warp testing its lanes' leaves together; the source says
why). On CPU tensors it runs the plain PyTorch version below, which walks
the same table in the kernel's per-lane order and arithmetic. There is no
fallback: a CUDA tensor launches the kernel or raises. Both size the
per-ray stack from the tree (`tree_stack`; the kernel is built with STACKS
entries and a launch takes the least that holds it, `stack_build`). A
malformed tree (a stack deeper than that bound, more than 4 P + 64 pair
visits for a ray of a P-row pair table, a child or row index out of range)
raises in both. `preorder_plain` is the reference's order of the walk (a
box a pop, left child first), by which the reference-order bound of the
kernel is counted (chip_smoke.py); it gives walk_plain's hits. A hit's
prim is its row (first + j), as in the reference.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .brute import mt_uvt
from .cluster import (COUNTERS as WALK_COUNTERS, ERR_INDEX, ERR_STACK, ERR_STEPS, _BIG, safe_inv,
                      slab, slab_range, stack_need)
from .subpacket import check_counters

NODE_COLS = 16
TRI_COLS = 16
PAIR_COLS = 16
# entries of the per-ray stacks the kernel is built with (csrc/trace.cu
# kStackSmall / kStackMid / kStackLarge): a launch takes the least that
# holds its tree's bound (tree_stack: depth + 1; a walk pushes at most one
# entry a level)
STACKS = (32, 64, 512)
# the kernel's optional per-launch counters (csrc/trace_common.cuh CTR_*)
COUNTERS = WALK_COUNTERS
# child codes of the pair table: an empty slot (row 0's second); a child
# index or leaf rows out of range in the node table (past every pair row,
# so that the walks raise where they enter it); a leaf is
# ~(first << LEAF_BITS | (rows - 1))
NONE = -(1 << 31)
BAD = (1 << 31) - 1
LEAF_BITS = 6

_ERRORS = {ERR_STACK: "a traversal stack deeper than the tree's bound",
           ERR_STEPS: "more than 4 P + 64 pair visits (pops) for a ray",
           ERR_INDEX: "a child or triangle index out of range"}

launches = 0


def pack_tables(geom):
    """(node table (N, 16), triangle table (P, 16)) float32 tensors from a
    TraceGeometry (accel/traverse.py; its fields tensors or numpy arrays),
    on their device."""
    def col(name):
        return torch.as_tensor(getattr(geom, name))

    amin = col("aabb_min")
    node = torch.zeros((amin.shape[0], NODE_COLS), dtype=torch.float32, device=amin.device)
    node[:, 0:3] = amin
    node[:, 3:6] = col("aabb_max")
    node[:, 6] = col("skip").to(torch.float32)
    node[:, 7] = col("node_count").to(torch.float32)
    node[:, 8] = col("node_first").to(torch.float32)

    v0 = col("tri_v0")
    tri = torch.zeros((v0.shape[0], TRI_COLS), dtype=torch.float32, device=v0.device)
    tri[:, 0:3] = v0
    tri[:, 3:6] = col("tri_e1")
    tri[:, 6:9] = col("tri_e2")
    tri[:, 9] = col("prim_index").to(torch.float32)
    return node, tri


def build_pairs(nodes, leaf_size):
    """The child-pair table (1 + I, 16) float32 of a node table (N, 16) with
    I interior nodes (count <= 0), on its device: 0:6 child 0's box (min
    xyz, max xyz), 6 and 7 the two children's codes (int32 bits), 8:14
    child 1's box. Row 0's child 0 is the root, its child 1 empty (NONE);
    row 1 + k holds the k-th interior node's left child (node + 1) and
    right child (skip[node + 1]). A code is the child's pair row (interior),
    ~(first << 6 | (m - 1)) for a leaf of m = min(count, leaf_size) rows
    from `first`, or BAD for a child index out of range or a first row
    outside [0, 2^24), whose box is then all of space."""
    n, dev = nodes.shape[0], nodes.device
    cnt = nodes[:, 7].to(torch.int64)
    interior = cnt <= 0
    inner = torch.nonzero(interior).squeeze(1)
    pair_row = torch.cumsum(interior.to(torch.int64), 0)  # 1 + rank, on interior nodes
    left = inner + 1
    right = torch.where(left < n, nodes[left.clamp(max=n - 1), 6].to(torch.int64), -1)
    space = torch.tensor([-math.inf] * 3 + [math.inf] * 3, device=dev)

    def child(c):
        ok = (c >= 0) & (c < n)
        k = c.clamp(0, n - 1)
        leaf = cnt[k] > 0
        first = nodes[k, 8].to(torch.int64)
        rows = cnt[k].clamp(max=leaf_size)
        leaf_ok = (first >= 0) & (first < (1 << 24))
        code = torch.where(leaf, ~((first.clamp(0, (1 << 24) - 1) << LEAF_BITS) | (rows - 1)),
                           pair_row[k])
        code = torch.where(ok & (~leaf | leaf_ok), code, BAD)
        return torch.where(ok[:, None], nodes[k, 0:6], space), code

    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    box0, code0 = child(torch.cat([zero, left]))
    box1, code1 = child(torch.cat([zero, right]))
    box1[0] = 0.0
    code1[0] = NONE
    pairs = torch.zeros((inner.numel() + 1, PAIR_COLS), dtype=torch.float32, device=dev)
    pairs[:, 0:6] = box0
    pairs[:, 8:14] = box1
    words = pairs.view(torch.int32)
    words[:, 6] = code0.to(torch.int32)
    words[:, 7] = code1.to(torch.int32)
    return pairs


def tree_stack(nodes, stack=None):
    """The stack bound of a walk over the node table (N, 16): `stack` when
    the caller has it, else ops/cluster.py stack_need of the tree (node i
    interior when its count is 0, pushing skip[i + 1] and i + 1: the tree's
    depth + 1, which holds the pair walk's at most one entry a level), read
    to the host. Raises when it is beyond the kernel's largest stack."""
    if stack is None:
        rows = nodes[:, 6:8].cpu().numpy()
        n = rows.shape[0]
        left = np.arange(1, n + 1)
        right = np.where(left < n, rows[np.minimum(left, n - 1), 0], -1).astype(np.int64)
        children = np.where((rows[:, 1] <= 0)[:, None], np.stack([right, left], 1), -1)
        stack = stack_need(children)
    if not 1 <= stack <= STACKS[-1]:
        raise RuntimeError(f"trace_closest: the tree's walk needs a stack of {stack} "
                           f"entries: a traversal stack deeper than the kernel's largest "
                           f"({STACKS[-1]})")
    return int(stack)


def stack_build(bound: int) -> int:
    """The entries of the kernel's stack build that a launch takes for a
    tree whose stack bound is `bound`: the least of STACKS that holds it (0:
    none does)."""
    return next((s for s in STACKS if 1 <= bound <= s), 0)


# ---------------------------------------------------------------------------
# plain PyTorch versions: batched walks with a stack per lane, one step per
# live lane an iteration, in the kernel's per-lane order and arithmetic
# ---------------------------------------------------------------------------


def _raise(err):
    msgs = [m for bit, m in _ERRORS.items() if err & bit]
    raise RuntimeError(f"trace_closest: malformed tree: {', '.join(msgs)}")


def _leaf_rows(rows, ox, oy, oz, dx, dy, dz, t_min):
    """Rows (k, L, 16) against k rays ((k, 1) each): (ok, t, u, v) (k, L),
    Moller-Trumbore in the reference kernel's order; ok leaves out the test
    against the best hit."""
    cols = rows[..., :10].unbind(-1)  # v0 / e1 / e2, original index
    big_det, inside, t, u, v = mt_uvt(*cols[:9], ox, oy, oz, dx, dy, dz)
    return big_det & inside & (t > t_min) & (cols[9] >= 0.0), t, u, v


def _decode(code):
    """(first row, rows) of leaf codes."""
    x = ~code
    return x >> LEAF_BITS, (x & ((1 << LEAF_BITS) - 1)) + 1


def _valid(code, n_pairs, n_rows):
    first, m = _decode(code)
    return torch.where(code >= 0, code < n_pairs, (code != NONE) & (first + m <= n_rows))


def walk_plain(o, d, t_min, t_max, nodes, tris, leaf_size, visited=None, stack=None,
               pairs=None):
    """The plain version of the kernel. Returns (t (inf on miss), prim (-1),
    u, v, stats (N, 3) int32: pair rows visited, leaves entered and rows
    tested per ray). `visited`, when given, is a pair of (1 + I,) and (P,)
    bool tensors in which the walk marks the pair rows visited and the rows
    tested; `stack` as for `closest`; `pairs`, build_pairs(nodes,
    leaf_size) when the caller has it."""
    n, dev = o.shape[0], o.device
    pairs = build_pairs(nodes, leaf_size) if pairs is None else pairs
    n_pairs, n_rows = pairs.shape[0], tris.shape[0]
    codes = pairs.view(torch.int32)[:, 6:8].to(torch.int64)
    max_steps = 4 * n_pairs + 64
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    best_t = torch.where(t_max < _BIG, t_max, _BIG)
    best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    stats = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    cap = tree_stack(nodes, stack)
    st_code = torch.zeros((n, cap), dtype=torch.int64, device=dev)
    st_near = torch.zeros((n, cap), dtype=torch.float32, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    active = t_min < best_t  # lanes live on entry visit row 0, the root's
    cur = torch.where(active, 0, NONE).to(torch.int64)  # NONE: pop the stack next
    parked = torch.full((n,), NONE, dtype=torch.int64, device=dev)

    while True:
        lanes = torch.nonzero(active).squeeze(1)
        if not lanes.numel():
            break
        at_leaf = parked[lanes] != NONE
        at_pair = ~at_leaf & (cur[lanes] != NONE)
        at_pop = ~at_leaf & ~at_pair

        ll = lanes[at_leaf]  # the parked leaves' rows
        if ll.numel():
            first, m = _decode(parked[ll])
            js = torch.arange(int(m.max()), device=dev)
            inside = js[None, :] < m[:, None]
            idx = torch.where(inside, first[:, None] + js[None, :], 0)
            ok, t, u, v = _leaf_rows(tris[idx], ox[ll, None], oy[ll, None], oz[ll, None],
                                     dx[ll, None], dy[ll, None], dz[ll, None], t_min[ll, None])
            ok = ok & inside & (t < best_t[ll, None])
            if visited is not None:
                visited[1][idx[inside]] = True
            stats[ll, 2] += m.to(torch.int32)
            # the first row of least t: an in-order strict t < best_t
            j = torch.argmin(torch.where(ok, t, math.inf), dim=1, keepdim=True)
            found = ok.any(dim=1)
            fl = ll[found]
            best_t[fl] = t.gather(1, j)[found, 0]
            best_u[fl] = u.gather(1, j)[found, 0]
            best_v[fl] = v.gather(1, j)[found, 0]
            best_p[fl] = idx.gather(1, j)[found, 0]
            parked[ll] = NONE

        pl_ = lanes[at_pop]  # the stack's top
        if pl_.numel():
            done = sp[pl_] == 0
            active[pl_[done]] = False
            q = pl_[~done]
            sp[q] -= 1
            code, near = st_code[q, sp[q]], st_near[q, sp[q]]
            keep = ~(near > best_t[q])  # else its box lies past the best hit
            q, code = q[keep], code[keep]
            leaf = code < 0
            parked[q[leaf]] = code[leaf]
            stats[q[leaf], 1] += 1
            cur[q[~leaf]] = code[~leaf]

        vl = lanes[at_pair]  # a pair row's two children
        if vl.numel():
            if bool((stats[vl, 0] >= max_steps).any()):
                _raise(ERR_STEPS)
            node = cur[vl]
            stats[vl, 0] += 1
            if visited is not None:
                visited[0][node] = True
            row = pairs[node]
            ray = (ox[vl], oy[vl], oz[vl], ix[vl], iy[vl], iz[vl], t_min[vl], best_t[vl])
            h0 = slab(row[:, 0:6], *ray)
            n1, f1 = slab_range(row[:, 8:14], *ray)
            c0, c1 = codes[node, 0], codes[node, 1]
            h0 = h0 & (c0 != NONE)
            h1 = (n1 <= f1) & (c1 != NONE)
            if bool(((h0 & ~_valid(c0, n_pairs, n_rows))
                     | (h1 & ~_valid(c1, n_pairs, n_rows))).any()):
                _raise(ERR_INDEX)
            both = h0 & h1  # child 0 first, child 1 pushed
            nxt = torch.where(h0, c0, torch.where(h1, c1, NONE))
            bl = vl[both]
            if bl.numel():
                if bool((sp[bl] >= cap).any()):
                    _raise(ERR_STACK)
                st_code[bl, sp[bl]] = c1[both]
                st_near[bl, sp[bl]] = n1[both]
                sp[bl] += 1
            leaf = (nxt < 0) & (nxt != NONE)
            parked[vl[leaf]] = nxt[leaf]
            stats[vl[leaf], 1] += 1
            cur[vl] = torch.where(nxt < 0, NONE, nxt)

    found = best_p >= 0
    return (torch.where(found, best_t, math.inf), best_p.to(torch.int32), best_u, best_v,
            stats)


def closest_plain(o, d, t_min, t_max, nodes, tris, leaf_size, stack=None, pairs=None):
    """Plain version of the kernel: (t, prim, u, v)."""
    return walk_plain(o, d, t_min, t_max, nodes, tris, leaf_size, stack=stack, pairs=pairs)[:4]


def preorder_plain(o, d, t_min, t_max, nodes, tris, leaf_size, visited=None, stack=None):
    """The walk in the reference's order over the node table: a pop tests
    one box, an interior node pushes its right child, then its left, and a
    leaf's rows take a strict t < best_t in order. Returns what walk_plain
    does, its stats counting node pops; `visited`, (N,) and (P,) masks of
    the nodes popped and the rows tested. It meets the boxes in walk_plain's
    order and gives its hits."""
    n, dev = o.shape[0], o.device
    n_nodes, n_rows = nodes.shape[0], tris.shape[0]
    max_steps = 4 * n_nodes + 64
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    best_t = torch.where(t_max < _BIG, t_max, _BIG)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    stats = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    cap = tree_stack(nodes, stack)
    stack = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    sp = (t_min < best_t).to(torch.int64)  # the root, on lanes live on entry
    js = torch.arange(leaf_size, device=dev)

    lanes = torch.nonzero(sp > 0).squeeze(1)
    while lanes.numel():
        if bool((stats[lanes, 0] >= max_steps).any()):
            _raise(ERR_STEPS)
        sp[lanes] -= 1
        node = stack[lanes, sp[lanes]].long()
        stats[lanes, 0] += 1
        if visited is not None:
            visited[0][node] = True
        row = nodes[node]
        hit = slab(row, ox[lanes], oy[lanes], oz[lanes], ix[lanes], iy[lanes], iz[lanes],
                   t_min[lanes], best_t[lanes])
        cnt = row[:, 7].to(torch.int64)
        first = row[:, 8].to(torch.int64)

        inner = hit & (cnt <= 0)
        il = lanes[inner]
        if il.numel():
            left = node[inner] + 1
            if bool((left >= n_nodes).any()):
                _raise(ERR_INDEX)
            right = nodes[left, 6].to(torch.int64)
            if bool(((right < 0) | (right >= n_nodes)).any()):
                _raise(ERR_INDEX)
            if bool((sp[il] + 2 > cap).any()):
                _raise(ERR_STACK)
            top = sp[il]
            stack[il, top] = right.to(torch.int32)
            stack[il, top + 1] = left.to(torch.int32)
            sp[il] = top + 2

        leaf = hit & (cnt > 0)
        ll = lanes[leaf]
        if ll.numel():
            lf, lcnt = first[leaf], torch.clamp(cnt[leaf], max=leaf_size)
            if bool(((lf < 0) | (lf + lcnt > n_rows)).any()):
                _raise(ERR_INDEX)
            inside = js[None, :] < lcnt[:, None]
            idx = torch.where(inside, lf[:, None] + js[None, :], 0)
            ok, t, u, v = _leaf_rows(tris[idx], ox[ll, None], oy[ll, None], oz[ll, None],
                                     dx[ll, None], dy[ll, None], dz[ll, None], t_min[ll, None])
            ok = ok & inside & (t < best_t[ll, None])
            if visited is not None:
                visited[1][idx[inside]] = True
            stats[ll, 1] += 1
            stats[ll, 2] += lcnt.to(torch.int32)
            found = ok.any(dim=1)
            # the first row of least t: an in-order strict t < best_t
            j = torch.argmin(torch.where(ok, t, math.inf), dim=1, keepdim=True)
            fl = ll[found]
            best_t[fl] = t.gather(1, j)[found, 0]
            best_u[fl] = u.gather(1, j)[found, 0]
            best_v[fl] = v.gather(1, j)[found, 0]
            best_p[fl] = (lf[:, None] + j)[found, 0].to(torch.int32)
        lanes = torch.nonzero(sp > 0).squeeze(1)

    found = best_p >= 0
    return torch.where(found, best_t, math.inf), best_p, best_u, best_v, stats


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("trace")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # rays, pairs, tris; outputs, stats, counters and the error word;
        # device and stream
        lib.trace_closest.argtypes = ([ptr] * 5 + [i32, ptr, i32, i32, i32] + [ptr] * 7
                                      + [i32, ptr])
        lib.trace_closest.restype = i32
        lib.trace_counters.restype = i32
        lib.trace_stack_build.argtypes = [i32]
        lib.trace_stack_build.restype = i32
        if lib.trace_counters() != len(COUNTERS):
            raise RuntimeError(f"csrc/trace.cu keeps {lib.trace_counters()} counters, "
                               f"ops/trace.py names {len(COUNTERS)}")
        for bound in (1, *STACKS, *(s + 1 for s in STACKS)):
            if lib.trace_stack_build(bound) != stack_build(bound):
                raise RuntimeError(f"csrc/trace.cu takes a {lib.trace_stack_build(bound)}-"
                                   f"entry stack for a bound of {bound}, ops/trace.py "
                                   f"STACKS {stack_build(bound)}")
        _LIB = lib
    return _LIB


def _check(o, d, t_min, t_max, nodes, tris, leaf_size, pairs=None):
    dev = o.device
    n = o.shape[0]
    for name, x, shape in (
        ("origin", o, (n, 3)), ("direction", d, (n, 3)),
        ("t_min", t_min, (n,)), ("t_max", t_max, (n,)),
        ("nodes", nodes, (nodes.shape[0], NODE_COLS)),
        ("tris", tris, (tris.shape[0], TRI_COLS)),
        *((("pairs", pairs, (pairs.shape[0], PAIR_COLS)),) if pairs is not None else ()),
    ):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, origin on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (0 < nodes.shape[0] < (1 << 24) and 0 < tris.shape[0] < (1 << 24)):
        raise ValueError(f"{nodes.shape[0]} nodes / {tris.shape[0]} rows: each must be "
                         "1 to 2^24 - 1")
    if not 1 <= leaf_size <= 64:
        raise ValueError(f"leaf size {leaf_size}: must be 1 to 64")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and any(x.data_ptr() % 16 for x in (nodes, tris, pairs)
                                  if x is not None):
        raise ValueError("the tables must be 16-byte aligned (float4 loads)")


def launch(o, d, t_min, t_max, nodes, tris, leaf_size, err, stats=None, stack=None,
           counters=None, pairs=None):
    """Queue one kernel launch on the current stream and return (t, prim, u,
    v) without waiting. Errors of the walk are OR-ed into `err` (one int32
    on the card); `stats`, when given, is an (N, 3) int32 tensor that
    receives pair visits, leaf visits and rows tested per ray; `counters`, a
    contiguous int64 tensor of len(COUNTERS) that the kernel adds its lane
    counters to; `stack` and `pairs` as for `closest`."""
    global launches
    n, dev = o.shape[0], o.device
    check_counters(counters, len(COUNTERS), dev)
    stack = tree_stack(nodes, stack)
    pairs = build_pairs(nodes, leaf_size) if pairs is None else pairs
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    rc = _library().trace_closest(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), pairs.data_ptr(),
        pairs.shape[0], tris.data_ptr(), tris.shape[0], stack, n, t.data_ptr(),
        prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        0 if stats is None else stats.data_ptr(),
        0 if counters is None else counters.data_ptr(), err.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trace kernel launch failed: CUDA error {rc}")
    launches += 1
    return t, prim, u, v


def closest(o, d, t_min, t_max, nodes, tris, leaf_size, stack=None, pairs=None):
    """Closest hit of each ray: (t (inf on miss), prim (the hit's row, -1 on
    miss), u, v). `stack`: the tree's stack bound when the caller has it
    (tree_stack), else it is computed from the node table; `pairs`: the
    tree's child-pair table (build_pairs(nodes, leaf_size)) when the caller
    has it, else it is built here."""
    _check(o, d, t_min, t_max, nodes, tris, leaf_size, pairs)
    if o.device.type == "cpu":
        return closest_plain(o, d, t_min, t_max, nodes, tris, leaf_size, stack, pairs)
    if o.shape[0] == 0:
        e = o.new_empty((0,))
        return e, torch.empty((0,), dtype=torch.int32, device=o.device), e, e
    err = torch.zeros((1,), dtype=torch.int32, device=o.device)
    out = launch(o, d, t_min, t_max, nodes, tris, leaf_size, err, stack=stack, pairs=pairs)
    code = int(err.item())  # waits for the launch
    if code:
        _raise(code)
    return out
