"""Closest-hit / any-hit traversal of the 8-wide cluster tree with Woop
triangle tests: the opt-in `LR_SUBPACKET=1` route for scenes above the
brute-force size.

Counterpart of luisarender_tpu/ops/subpacket_pallas.py. Its host side is
copied here: `build_woop_table`, `build_bvh8` and `build_slab_meta` give
the reference's tables bit for bit from the cluster tables of
ops/cluster.py (the wide8 route of ops/wide8.py walks the same BVH8).

- slab8 (N8, 8, 128) float32: node n's child c has its box planes in
  columns p * 8 + c (p = 2a for the low plane of axis a, 2a + 1 for the
  high one): row a holds the bound, row 3 + a a one, row 6 +inf for an
  empty slot; columns 48+ are zero.
- meta8 (N8, 16) float32: columns 0-7 each child's code (>= 1 an interior
  child's node index, <= -1 a leaf: cluster -code - 1, 0 an empty slot),
  column 8 the children's sort axis + 4 * the leaf bit mask; row 0,
  columns 10-15 the scene's bounds.
- Woop blocks (C, 8, 1024) float32: cluster c's triangle j has in column
  g * 128 + j the coefficients on the ray features [ox, oy, oz, 1, dx, dy,
  dz, 0] (rows) of o'x, o'y, o'z (g = 0-2: the unit-triangle transform of
  o - v0), d'x, d'y, d'z (g = 3-5), and on the constant row the slot
  (g = 6, -1 for padding or a degenerate triangle) and opacity (g = 7).
  The builder writes the same float32 coefficients into the direction rows
  of groups 3-5 as into the origin rows of groups 0-2, so the row tests
  below (woop_tests) and the kernels take d' from the origin rows: 12
  coefficients and the slot a triangle.

On CUDA tensors `closest` / `any_hit` launch csrc/subpacket.cu (a lane a
ray walking the tree, each warp testing its lanes' leaf clusters
together; the source says why). On CPU tensors they run the plain PyTorch
versions below (`walk8_plain`), which walk the same tree in the kernel's
per-lane order and arithmetic. There is no fallback: a CUDA tensor
launches the kernel or raises. Both size the per-ray stack from the tree
(`stack8_need`; the kernels are built with STACKS8 entries and a launch
takes the least that holds it, `stack_build`). A malformed tree (a stack
deeper than that bound, more than 4 N8 + 64 pops for a ray, a child or
cluster index out of range) raises in both. `closest` and `any_hit` are
torch.autograd.Functions that pass no gradient (ops/nograd.py), as the
reference's custom VJP passes zeros.

The reference's wrapper sorts launches of at least 32,768 rays into
coherent packets first (subpacket_pallas.py:596-608, MIN_SORT_RAYS).
`coherence_order` is that order, over the scene's bounds in meta8's row 0,
and `launch_sorted` that route; each ray's walk is its own, so the
outputs are the same in either order. `closest` / `any_hit` launch in
caller order: on the H100 the sort costs more than it saves (PERF.md).

The Woop test's t, u, v are an algebraic rearrangement of Moller-Trumbore,
so a hit's (u, v) is not returned: `closest` gives bary = NaN, and
scene/geometry.py `surface_interaction` recomputes it from the winner's
shade row when ENABLED is set, as in the reference.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from .cluster import CLUSTER, COUNTERS as WALK_COUNTERS, ERR_INDEX, ERR_STACK, ERR_STEPS, _BIG
from .cluster import coherence_keys, safe_inv, stack_need
from .nograd import no_grad_entry

# the route is taken only when asked for, as in the reference
ENABLED = os.environ.get("LR_SUBPACKET", "0") != "0"

GROUPS = 8  # o'x o'y o'z d'x d'y d'z slot opaque
WOOP_COLS = GROUPS * CLUSTER  # 1024
N8_COLS = 64
SLAB_COLS = 128
# the scene compiler builds the 8-wide tables only for trees of at most
# this many nodes, as the reference does (there the cap is the TPU's VMEM,
# which holds the whole slab table), so the same scenes take the route
MAX_SLAB8_NODES = 2048
# entries of the per-lane stacks the 8-wide kernels (csrc/subpacket.cu,
# csrc/wide8.cu) are built with (csrc/trace_common.cuh kStack8Small /
# kStack8Large): a launch takes the least that holds its tree's bound
# (stack8_need, stack_build), and the larger holds the bound of any tree of
# at most MAX_SLAB8_NODES nodes, since a walk pushes each node at most once
STACKS8 = (48, MAX_SLAB8_NODES)
# the kernel's optional per-launch lane counters (csrc/trace_common.cuh
# CTR_*): the cluster kernel's
COUNTERS = WALK_COUNTERS
# lanes whose leaf blocks the plain version gathers at once: the 14 columns
# of 128 rows it reads of each are 29 MB at 4096 lanes
WOOP_CHUNK = 4096

_ERRORS = {ERR_STACK: "a traversal stack deeper than the tree's bound",
           ERR_STEPS: "more than 4 N8 + 64 node pops for a ray",
           ERR_INDEX: "a child or cluster index out of range"}

closest_launches = 0
any_launches = 0


# ---------------------------------------------------------------------------
# host-side tables (the reference's numpy, line for line)
# ---------------------------------------------------------------------------


def build_woop_table(tri_table: np.ndarray) -> np.ndarray:
    """(C, 8, WOOP_COLS) float32 Woop blocks from the cluster triangle
    blocks (C, 16, 128) of ops/cluster.py build_cluster_tables."""
    tri = np.asarray(tri_table, np.float32)
    c = tri.shape[0]
    v0 = tri[:, 0:3, :].transpose(0, 2, 1).reshape(-1, 3)  # (C*128, 3)
    e1 = tri[:, 3:6, :].transpose(0, 2, 1).reshape(-1, 3)
    e2 = tri[:, 6:9, :].transpose(0, 2, 1).reshape(-1, 3)
    valid = tri[:, 9, :].reshape(-1) > 0.0
    opq = tri[:, 10, :].reshape(-1)
    slot = tri[:, 11, :].reshape(-1)

    n = np.cross(e1, e2)
    # A = [e1 | e2 | n] (columns); W = A^-1 via the adjugate. det(A) = |n|^2.
    det = np.einsum("ij,ij->i", n, n)
    ok = valid & (det > 1e-30) & np.isfinite(det)
    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    # rows of W: cross products of A's other two columns over det
    w0 = np.cross(e2, n) * inv_det[:, None]
    w1 = np.cross(n, e1) * inv_det[:, None]
    w2 = n * inv_det[:, None]
    slot = np.where(ok, slot, -1.0)

    woop = np.zeros((c * CLUSTER, GROUPS, 8), np.float32)
    for g, w in enumerate((w0, w1, w2)):
        woop[:, g, 0:3] = w
        woop[:, g, 3] = -np.einsum("ij,ij->i", w, v0)
        woop[:, g + 3, 4:7] = w
    woop[:, 6, 3] = slot
    woop[:, 7, 3] = np.where(ok, opq, 0.0)
    # -> (C, 8 features, GROUPS*128): group-major columns, triangle minor
    woop = woop.reshape(c, CLUSTER, GROUPS, 8).transpose(0, 3, 2, 1)
    return np.ascontiguousarray(woop.reshape(c, 8, WOOP_COLS))


def build_bvh8(node_table: np.ndarray) -> np.ndarray:
    """Collapse the binary cluster tree ((N, 8) rows of build_cluster_tables)
    into an (N8, 64) 8-wide table: child c at columns c * 8 .. c * 8 + 7
    (box min, box max, code), the sort axis in column 7. Starting from a
    binary node, the largest-surface-area interior member is expanded until
    8 members are reached; members that stay interior become 8-ary
    children, binary leaves leaf slots. Nodes are numbered breadth first;
    children are sorted by centroid along the axis of largest centroid
    spread."""
    node = np.asarray(node_table, np.float32)
    right = np.floor(node[:, 6]).astype(np.int64)  # -1 = leaf
    first = node[:, 7].astype(np.int64)  # leaf cluster block, -1 interior
    is_leaf = first >= 0

    mins = node[:, 0:3]
    maxs = node[:, 3:6]
    # float64: padded rows carry +/-BIG sentinels whose difference overflows
    ext = np.maximum(maxs.astype(np.float64) - mins.astype(np.float64), 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    def collect(i):
        group = [int(i)]
        while len(group) < 8:
            cand = [g for g in group if not is_leaf[g]]
            if not cand:
                break
            g = max(cand, key=lambda x: area[x])
            if len(group) + 1 > 8:
                break
            group.remove(g)
            group += [g + 1, int(right[g])]
        return group

    records = []
    queue = [0]
    index_of = {0: 0}
    records.append(None)
    qi = 0
    while qi < len(queue):
        b = queue[qi]
        my8 = index_of[b]
        qi += 1
        group = collect(b)
        cents = 0.5 * (mins[group] + maxs[group])
        axis = (
            int(np.argmax(cents.max(0) - cents.min(0)))
            if len(group) > 1 else 0
        )
        group = sorted(
            group, key=lambda g: 0.5 * (mins[g][axis] + maxs[g][axis])
        )
        rec = np.zeros(N8_COLS, np.float32)
        for c in range(8):
            base = c * 8
            if c < len(group):
                g = group[c]
                rec[base:base + 3] = mins[g]
                rec[base + 3:base + 6] = maxs[g]
                if is_leaf[g]:
                    rec[base + 6] = -float(first[g]) - 1.0
                else:
                    idx = index_of.get(g)
                    if idx is None:
                        idx = len(records)
                        index_of[g] = idx
                        records.append(None)
                        queue.append(g)
                    rec[base + 6] = float(idx)
            else:
                rec[base + 0] = _BIG
                rec[base + 3] = -_BIG
        rec[7] = float(axis)
        records[my8] = rec
    table8 = np.stack(records, axis=0)
    assert table8.shape[0] < (1 << 23)
    return table8


def build_slab_meta(table8: np.ndarray):
    """(slab8 (N8, 8, SLAB_COLS), meta8 (N8, 16)) float32 from the (N8, 64)
    BVH8 table (layouts in the module docstring). An empty slot's planes
    are +inf on the constant row, so its slab test fails for every ray."""
    t8 = np.asarray(table8, np.float32)
    n8 = t8.shape[0]
    rec = t8.reshape(n8, 8, 8)
    mins = rec[:, :, 0:3]
    maxs = rec[:, :, 3:6]
    enc = rec[:, :, 6]
    axis = rec[:, 0, 7]
    empty = mins[:, :, 0] >= 1e29

    slab = np.zeros((n8, 8, SLAB_COLS), np.float32)
    for a in range(3):
        for hi in range(2):
            p = 2 * a + hi
            cols = slice(p * 8, p * 8 + 8)
            bound = (maxs if hi else mins)[:, :, a]
            slab[:, a, cols] = np.where(empty, 0.0, bound)
            slab[:, 3 + a, cols] = np.where(empty, 0.0, 1.0)
            slab[:, 6, cols] = np.where(empty, np.inf, 0.0)

    leafmask = ((enc <= -1.0) & ~empty).astype(np.int64)
    packed = axis.astype(np.int64) + 4 * (
        leafmask * (1 << np.arange(8))[None, :]
    ).sum(axis=1)
    meta = np.zeros((n8, 16), np.float32)
    meta[:, 0:8] = np.where(empty, 0.0, enc)
    meta[:, 8] = packed.astype(np.float32)
    valid = ~empty
    lo = np.min(np.where(valid[0][:, None], mins[0], _BIG), axis=0)
    hi = np.max(np.where(valid[0][:, None], maxs[0], -_BIG), axis=0)
    meta[0, 10:13] = lo
    meta[0, 13:16] = hi
    return slab, meta


def bvh8_depth(meta8) -> int:
    """Levels of nodes on the longest root-to-leaf path of the 8-wide tree;
    raises ValueError on a child index out of range or a cycle."""
    enc = np.asarray(meta8, np.float32)[:, 0:8]
    n8 = enc.shape[0]
    level, depth = [0], 0
    while level:
        depth += 1
        if depth > n8:
            raise ValueError("the 8-wide tree has a cycle")
        kids = enc[level]
        kids = kids[kids >= 1.0].astype(np.int64)
        if np.any(kids >= n8):
            raise ValueError("an 8-wide child index is out of range")
        level = np.unique(kids).tolist()
    return depth


def stack8_need(meta8) -> int:
    """The per-ray stack a walk of the 8-wide tree can need (ops/cluster.py
    stack_need; at most 7 D + 1 for D levels of nodes): a node pushes its
    interior children (codes >= 1 off the leaf mask)."""
    meta = np.asarray(meta8, np.float32)
    enc = meta[:, 0:8]
    leaf = ((meta[:, 8].astype(np.int64)[:, None] >> 2) >> np.arange(8)) & 1 > 0
    return stack_need(np.where((enc != 0.0) & ~leaf, enc, -1.0).astype(np.int64))


def stack_build(bound: int) -> int:
    """The entries of the 8-wide kernel build a launch takes for a tree whose
    stack bound is `bound`: the least of STACKS8 that holds it (0: none
    does)."""
    return next((s for s in STACKS8 if 1 <= bound <= s), 0)


def coherence_order(o, d, t_min, t_max, meta8):
    """The reference's ray order for a launch of the 8-wide kernels
    (subpacket_pallas.py:596-608, wide8_pallas.py:340-352): ops/cluster.py
    coherence_keys over the scene's bounds in meta8[0, 10:16], stable, as
    int64 indices."""
    lo, hi = meta8[0, 10:13], meta8[0, 13:16]
    key = coherence_keys(o, d, t_min, t_max, lo, hi - lo)
    return torch.sort(key.to(torch.int32), stable=True).indices


def resolve_stack8(meta8, stack, name):
    """The stack bound of a walk over meta8: `stack` when the caller has it
    (ScenePlan.bvh8_stack), else stack8_need of meta8 (read to the host).
    Raises when it is beyond the kernels' largest stack."""
    if stack is None:
        stack = stack8_need(meta8.cpu().numpy())
    if not 1 <= stack <= STACKS8[-1]:
        raise RuntimeError(f"{name}: the 8-wide tree's walk needs a stack of {stack} entries: "
                           f"a traversal stack deeper than the kernels' largest "
                           f"({STACKS8[-1]})")
    return int(stack)


# ---------------------------------------------------------------------------
# plain PyTorch version of the 8-wide walk, shared with ops/wide8.py: a
# batched walk with a stack per lane, one pop per live lane an iteration,
# in the kernels' per-lane order and arithmetic
# ---------------------------------------------------------------------------


class WalkState:
    """Per-lane results and counts of one 8-wide walk: best_t / best_s /
    best_u / best_v (closest), occ (any-hit), stats (N, 3) int32 node
    pops, clusters tested, triangle rows tested; `visited`, when asked for,
    (N8,) and (C,) bool masks of the nodes popped and the clusters whose
    rows some ray tested."""

    def __init__(self, n, t_max, dev, visited=None):
        self.best_t = torch.where(t_max < _BIG, t_max, _BIG)
        self.best_s = torch.full((n,), -1, dtype=torch.int32, device=dev)
        self.best_u = torch.zeros_like(self.best_t)
        self.best_v = torch.zeros_like(self.best_t)
        self.occ = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.stats = torch.zeros((n, 3), dtype=torch.int32, device=dev)
        self.visited = visited

    def mark_clusters(self, blk):
        if self.visited is not None:
            self.visited[1][blk] = True


def raise_walk_error(err, name):
    msgs = [m for bit, m in _ERRORS.items() if err & bit]
    raise RuntimeError(f"{name}: malformed 8-wide tree: {', '.join(msgs)}")


def child_hits(slab, ix, iy, iz, nox, noy, noz, t_min, t_far):
    """The 8 children's slab tests of k popped nodes (k, 8, 128) against
    their k rays: planes bound * inv + (-o * inv), NaN-ignoring min / max,
    as the kernels' fminf / fmaxf. Empty slots are the caller's."""
    t0x = slab[:, 0, 0:8] * ix[:, None] + nox[:, None]
    t1x = slab[:, 0, 8:16] * ix[:, None] + nox[:, None]
    t0y = slab[:, 1, 16:24] * iy[:, None] + noy[:, None]
    t1y = slab[:, 1, 24:32] * iy[:, None] + noy[:, None]
    t0z = slab[:, 2, 32:40] * iz[:, None] + noz[:, None]
    t1z = slab[:, 2, 40:48] * iz[:, None] + noz[:, None]
    near = torch.fmax(torch.fmax(torch.fmin(t0x, t1x), torch.fmin(t0y, t1y)),
                      torch.fmax(torch.fmin(t0z, t1z), t_min[:, None]))
    far = torch.fmin(torch.fmin(torch.fmax(t0x, t1x), torch.fmax(t0y, t1y)),
                     torch.fmin(torch.fmax(t0z, t1z), t_far[:, None]))
    return near <= far


def walk8_plain(o, d, t_min, t_max, slab8, meta8, n_clusters, leaf_test, any_hit, name,
                stack, visited=None):
    """The 8-wide walk of both kernels. Each pop tests the node's 8 child
    boxes against the ray's best t at the pop; the hit leaf children are
    then handed to `leaf_test(state, lanes, clusters, ray)` one by one in
    visit order (ascending along the node's axis when the ray's direction
    component there is >= 0, else descending), and the hit interior
    children pushed in reverse visit order, so the nearest pops next.
    Any-hit lanes leave the walk at their first occluder; a lane's stack
    holds `stack` entries. Returns the WalkState (`visited`: its masks, or
    None)."""
    n, dev = o.shape[0], o.device
    n8 = slab8.shape[0]
    max_steps = 4 * n8 + 64
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    nox, noy, noz = -ox * ix, -oy * iy, -oz * iz
    ray = (ox, oy, oz, dx, dy, dz, ix, iy, iz, t_min)
    st = WalkState(n, t_max, dev, visited)
    cap = stack
    stack = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    sp = (t_min < st.best_t).to(torch.int64)  # the root, on lanes live on entry
    ks = torch.arange(8, device=dev)

    lanes = torch.nonzero(sp > 0).squeeze(1)
    while lanes.numel():
        if bool((st.stats[lanes, 0] >= max_steps).any()):
            raise_walk_error(ERR_STEPS, name)
        sp[lanes] -= 1
        node = stack[lanes, sp[lanes]].long()
        st.stats[lanes, 0] += 1
        if visited is not None:
            visited[0][node] = True
        meta = meta8[node]
        enc = meta[:, 0:8]
        packed = meta[:, 8].to(torch.int64)
        axis = packed & 3
        is_leaf = ((packed[:, None] >> 2) >> ks) & 1 > 0
        hit = child_hits(slab8[node], ix[lanes], iy[lanes], iz[lanes], nox[lanes],
                         noy[lanes], noz[lanes], t_min[lanes], st.best_t[lanes])
        hit = hit & (enc != 0.0)
        leaf_hit = hit & is_leaf
        inner = hit & ~is_leaf
        code = enc.to(torch.int64)
        blk_code = (-enc - 1.0).to(torch.int64)
        if bool((leaf_hit & ((blk_code < 0) | (blk_code >= n_clusters))).any()) or bool(
                (inner & ((code < 1) | (code >= n8))).any()):
            raise_walk_error(ERR_INDEX, name)
        dax = torch.where(axis == 0, dx[lanes], torch.where(axis == 1, dy[lanes], dz[lanes]))
        asc = dax >= 0.0
        # visit order: child k of the visit is c = k ascending, 7 - k descending
        order = torch.where(asc[:, None], ks[None, :], 7 - ks[None, :])
        for k in range(8):
            c = order[:, k:k + 1]
            take = leaf_hit.gather(1, c)[:, 0]
            if any_hit:
                take = take & ~st.occ[lanes]
            sel = torch.nonzero(take).squeeze(1)
            if sel.numel():
                leaf_test(st, lanes[sel], blk_code.gather(1, c)[sel, 0], ray)
        n_push = inner.sum(dim=1)
        if any_hit:
            n_push = torch.where(st.occ[lanes], 0, n_push)
        if bool((sp[lanes] + n_push > cap).any()):
            raise_walk_error(ERR_STACK, name)
        for k in range(8):  # reverse visit order
            c = order[:, 7 - k:8 - k]
            push = inner.gather(1, c)[:, 0]
            if any_hit:
                push = push & ~st.occ[lanes]
            pl_ = lanes[push]
            if pl_.numel():
                stack[pl_, sp[pl_]] = code.gather(1, c)[push, 0].to(torch.int32)
                sp[pl_] += 1
        if any_hit:
            sp[lanes[st.occ[lanes]]] = 0
        lanes = torch.nonzero(sp > 0).squeeze(1)
    return st


def fma32(a, b, c):
    """a * b + c of float32 tensors rounded once to float32: an IEEE fused
    multiply-add, as CUDA's fmaf and XLA's contracted multiply-adds give
    it. The product is exact in float64; the float64 sum is turned into its
    round-to-odd value with its exact TwoSum error, from which one rounding
    to float32 is the correctly rounded result (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    inexact_even = (err != 0.0) & torch.isfinite(err) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0.0, math.inf, -math.inf).to(torch.float64)
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def woop_tests(woop, blk, ox, oy, oz, dx, dy, dz, t_min, best_t, any_hit):
    """Every row of the Woop blocks `blk` (k,) of the table (C, 8, 1024)
    against k rays ((k, 1) each): (ok (k, 128), t, slot). o' and d' are
    the dot products of the block's rows with the ray features [ox, oy, oz,
    1, dx, dy, dz, 0] in row order as fused multiply-adds (fma32), and u, v
    = fma(t, d', o'): the reference's matmul and sums as XLA compiles them,
    bit for bit; the terms on rows the block holds zero in are left out,
    since adding an exact zero changes no result. d' takes its coefficients
    from the origin rows of groups 0-2, which build_woop_table fills with
    the same float32 values as the direction rows of groups 3-5. Only the
    columns read are gathered: 12 coefficients and the slot a row, the
    opacity for any-hit."""
    def g(k, grp):
        return woop[:, k, grp * CLUSTER:(grp + 1) * CLUSTER][blk]

    w = [[g(f, q) for f in range(4)] for q in range(3)]
    opx, opy, opz = (fma32(c[2], oz, fma32(c[1], oy, c[0] * ox)) + c[3] for c in w)
    dpx, dpy, dpz = (fma32(c[2], dz, fma32(c[1], dy, c[0] * dx)) for c in w)
    slot = g(3, 6)
    t = -opz / dpz
    u = fma32(t, dpx, opx)
    v = fma32(t, dpy, opy)
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < best_t)
          & (slot >= 0.0))
    if any_hit:
        ok = ok & (g(3, 7) > 0.5)
    return ok, t, slot


def _woop_leaf(woop, any_hit):
    def leaf_test(st, lc_all, blk_all, ray):
        ox, oy, oz, dx, dy, dz, _ix, _iy, _iz, t_min = ray
        for c0 in range(0, lc_all.numel(), WOOP_CHUNK):
            lc, blk = lc_all[c0:c0 + WOOP_CHUNK], blk_all[c0:c0 + WOOP_CHUNK]
            ok, t, slot = woop_tests(woop, blk, ox[lc, None], oy[lc, None], oz[lc, None],
                                     dx[lc, None], dy[lc, None], dz[lc, None],
                                     t_min[lc, None], st.best_t[lc, None], any_hit)
            rows = slot >= 0.0
            st.stats[lc, 1] += 1
            st.mark_clusters(blk)
            found = ok.any(dim=1)
            if any_hit:
                # the kernel stops at the first occluder
                j = torch.argmax(ok.to(torch.int32), dim=1)
                upto = torch.arange(CLUSTER, device=t.device)[None, :] <= j[:, None]
                tested = torch.where(found[:, None], rows & upto, rows)
                st.stats[lc, 2] += tested.sum(dim=1).to(torch.int32)
                st.occ[lc[found]] = True
                continue
            st.stats[lc, 2] += rows.sum(dim=1).to(torch.int32)
            # the least t, on equal t the least slot
            tk = torch.where(ok, t, math.inf)
            tbest = tk.min(dim=1, keepdim=True).values
            sbest = torch.where(ok & (tk == tbest), slot, _BIG).min(dim=1).values
            fl = lc[found]
            st.best_t[fl] = tbest[found, 0]
            st.best_s[fl] = sbest[found].to(torch.int32)
    return leaf_test


def subpacket_plain(o, d, t_min, t_max, slab8, meta8, woop, any_hit, visited=None,
                    stack=None):
    """The plain version of both kernel modes: the WalkState (best_t and
    best_s are the closest hit's t and slot before the miss fill)."""
    name = "subpacket_any" if any_hit else "subpacket_closest"
    return walk8_plain(o, d, t_min, t_max, slab8, meta8, woop.shape[0],
                       _woop_leaf(woop, any_hit), any_hit, name,
                       resolve_stack8(meta8, stack, name), visited)


def closest_plain(o, d, t_min, t_max, slab8, meta8, woop, stack=None):
    """Plain version of the closest-hit kernel: (t (inf on miss), slot)."""
    st = subpacket_plain(o, d, t_min, t_max, slab8, meta8, woop, False, stack=stack)
    found = st.best_s >= 0
    return torch.where(found, st.best_t, math.inf), st.best_s


def any_plain(o, d, t_min, t_max, slab8, meta8, woop, stack=None):
    """Plain version of the any-hit kernel: bool occlusion per ray."""
    return subpacket_plain(o, d, t_min, t_max, slab8, meta8, woop, True, stack=stack).occ


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("subpacket")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        args = [ptr] * 6 + [i32, ptr, i32, i32, i32]
        # outputs, stats, counters and the error word; device and stream
        lib.subpacket_closest.argtypes = args + [ptr] * 5 + [i32, ptr]
        lib.subpacket_closest.restype = i32
        lib.subpacket_any.argtypes = args + [ptr] * 4 + [i32, ptr]
        lib.subpacket_any.restype = i32
        lib.subpacket_counters.restype = i32
        lib.subpacket_stack_build.argtypes = [i32]
        lib.subpacket_stack_build.restype = i32
        if lib.subpacket_counters() != len(COUNTERS):
            raise RuntimeError(f"csrc/subpacket.cu keeps {lib.subpacket_counters()} counters, "
                               f"ops/subpacket.py names {len(COUNTERS)}")
        for bound in (1, STACKS8[0], STACKS8[0] + 1, STACKS8[-1], STACKS8[-1] + 1):
            if lib.subpacket_stack_build(bound) != stack_build(bound):
                raise RuntimeError(f"csrc/subpacket.cu takes a "
                                   f"{lib.subpacket_stack_build(bound)}-entry stack for a "
                                   f"bound of {bound}, ops/subpacket.py STACKS8 "
                                   f"{stack_build(bound)}")
        _LIB = lib
    return _LIB


def check_counters(counters, n_counters, dev):
    """Raise unless `counters` is None or a contiguous int64 (n_counters,)
    tensor on `dev`."""
    if counters is not None and (counters.device != dev or counters.dtype != torch.int64
                                 or counters.shape != (n_counters,)
                                 or not counters.is_contiguous()):
        raise ValueError(f"counters must be a contiguous int64 ({n_counters},) tensor on {dev}")


def check_bvh8(o, d, t_min, t_max, slab8, meta8, extra):
    """Device, type, shape and contiguity of the rays, the 8-wide tables
    and `extra` ((name, tensor, shape) of the leaf tables)."""
    dev = o.device
    n = o.shape[0]
    n8 = slab8.shape[0]
    for name, x, shape in (
        ("origin", o, (n, 3)), ("direction", d, (n, 3)),
        ("t_min", t_min, (n,)), ("t_max", t_max, (n,)),
        ("slab8", slab8, (n8, 8, SLAB_COLS)), ("meta8", meta8, (n8, 16)), *extra,
    ):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, origin on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n8 == 0 or n8 >= (1 << 23) or extra[0][1].shape[0] >= (1 << 17):
        raise ValueError(f"{n8} 8-wide nodes / {extra[0][1].shape[0]} clusters: nodes must "
                         "be 1 to 2^23 - 1, clusters below 2^17")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and (slab8.data_ptr() % 16 or meta8.data_ptr() % 16):
        raise ValueError("slab8 and meta8 must be 16-byte aligned (float4 loads)")


def _check(o, d, t_min, t_max, slab8, meta8, woop):
    check_bvh8(o, d, t_min, t_max, slab8, meta8,
               (("woop", woop, (woop.shape[0], 8, WOOP_COLS)),))


def launch(o, d, t_min, t_max, slab8, meta8, woop, any_hit, err, stats=None, stack=None,
           counters=None):
    """Queue one kernel launch on the current stream and return its outputs
    without waiting: closest (t, slot) or any-hit occlusion (int32). The
    rays are walked in the order given. Errors of the walk are OR-ed into
    `err` (one int32 on the card); `stats`, when given, is an (N, 3) int32
    tensor that receives the walk's counts (as WalkState.stats); `stack`,
    the tree's stack bound (resolve_stack8); `counters`, a contiguous int64
    tensor of len(COUNTERS) that the kernel adds its lane counters to."""
    global closest_launches, any_launches
    n, dev = o.shape[0], o.device
    check_counters(counters, len(COUNTERS), dev)
    lib = _library()
    stack = resolve_stack8(meta8, stack, "subpacket_any" if any_hit else "subpacket_closest")
    common = (o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
              slab8.data_ptr(), meta8.data_ptr(), slab8.shape[0], woop.data_ptr(),
              woop.shape[0], stack, n)
    tail = (0 if stats is None else stats.data_ptr(),
            0 if counters is None else counters.data_ptr(), err.data_ptr(), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    if any_hit:
        occ = torch.empty((n,), dtype=torch.int32, device=dev)
        rc = lib.subpacket_any(*common, occ.data_ptr(), *tail)
        out = occ
    else:
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        slot = torch.empty((n,), dtype=torch.int32, device=dev)
        rc = lib.subpacket_closest(*common, t.data_ptr(), slot.data_ptr(), *tail)
        out = (t, slot)
    if rc != 0:
        raise RuntimeError(f"subpacket kernel launch failed: CUDA error {rc}")
    if any_hit:
        any_launches += 1
    else:
        closest_launches += 1
    return out


def unsort(x, perm):
    """Outputs of rays taken in the order `perm` (a tensor, or a tuple of
    them, indexed by ray along dimension 0) back in caller order."""
    if isinstance(x, tuple):
        return tuple(unsort(y, perm) for y in x)
    out = torch.empty_like(x)
    out[perm] = x
    return out


def launch_sorted(o, d, t_min, t_max, slab8, meta8, woop, any_hit, err, stats=None,
                  stack=None, counters=None):
    """The reference's route for a launch of 32,768 rays or more
    (subpacket_pallas.py:596-608, 667-669): `launch` on the rays in
    coherence_order, its outputs (and `stats`) scattered back to caller
    order."""
    perm = coherence_order(o, d, t_min, t_max, meta8)
    rays = [x.index_select(0, perm) for x in (o, d, t_min, t_max)]
    walk = None if stats is None else torch.empty_like(stats)
    out = launch(*rays, slab8, meta8, woop, any_hit, err, walk, stack, counters)
    if stats is not None:
        stats[perm] = walk
    return unsort(out, perm)


def _run(o, d, t_min, t_max, slab8, meta8, woop, any_hit, stack):
    err = torch.zeros((1,), dtype=torch.int32, device=o.device)
    out = launch(o, d, t_min, t_max, slab8, meta8, woop, any_hit, err, stack=stack)
    code = int(err.item())  # waits for the launch
    if code:
        raise_walk_error(code, "subpacket_any" if any_hit else "subpacket_closest")
    return out


@no_grad_entry
def closest(o, d, t_min, t_max, slab8, meta8, woop, stack=None):
    """Closest hit of each ray: (t (inf on miss), slot (-1 on miss), u, v)
    with u = v = NaN: the exact (u, v) are the caller's to recompute.
    `stack`: the tree's stack bound when the caller has it (ScenePlan
    .bvh8_stack), else it is computed from meta8."""
    _check(o, d, t_min, t_max, slab8, meta8, woop)
    if o.device.type == "cpu":
        t, slot = closest_plain(o, d, t_min, t_max, slab8, meta8, woop, stack)
    elif o.shape[0] == 0:
        t, slot = o.new_empty((0,)), torch.empty((0,), dtype=torch.int32, device=o.device)
    else:
        t, slot = _run(o, d, t_min, t_max, slab8, meta8, woop, False, stack)
    nan = torch.full_like(t, math.nan)
    return t, slot, nan, nan


@no_grad_entry
def any_hit(o, d, t_min, t_max, slab8, meta8, woop, stack=None):
    """Occlusion of each ray by any opaque triangle within (t_min, t_max);
    `stack` as for `closest`."""
    _check(o, d, t_min, t_max, slab8, meta8, woop)
    if o.device.type == "cpu":
        return any_plain(o, d, t_min, t_max, slab8, meta8, woop, stack)
    if o.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=o.device)
    return _run(o, d, t_min, t_max, slab8, meta8, woop, True, stack) > 0
