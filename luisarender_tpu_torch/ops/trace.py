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

On CUDA tensors `closest` launches csrc/trace.cu (one thread a ray, a
per-thread stack; the source says why). On CPU tensors it runs the plain
PyTorch version below, which walks the same tree in the kernel's per-lane
order and arithmetic. There is no fallback: a CUDA tensor launches the
kernel or raises. Both size the per-ray stack from the tree
(`tree_stack`; the kernel is built with STACKS entries and a launch takes
the least that holds it). A malformed tree (a stack deeper than that
bound, more than 4 N + 64 pops for a ray, a child or row index out of
range) raises in both. A hit's prim is its row (first + j), as in the
reference.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .brute import mt_uvt
from .cluster import ERR_INDEX, ERR_STACK, ERR_STEPS, _BIG, safe_inv, slab, stack_need

NODE_COLS = 16
TRI_COLS = 16
# entries of the per-ray stacks the kernel is built with (csrc/
# trace_common.cuh kStack2Small / kStack2Large): a launch takes the least
# that holds its tree's bound (tree_stack: depth + 1, as a walk pushes both
# children and pops one)
STACKS = (64, 512)

_ERRORS = {ERR_STACK: "a traversal stack deeper than the tree's bound",
           ERR_STEPS: "more than 4 N + 64 node pops for a ray",
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


def tree_stack(nodes, stack=None):
    """The stack bound of a walk over the node table (N, 16): `stack` when
    the caller has it, else ops/cluster.py stack_need of the tree (node i
    interior when its count is 0, pushing skip[i + 1] and i + 1), read to
    the host. Raises when it is beyond the kernel's largest stack."""
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


# ---------------------------------------------------------------------------
# plain PyTorch version: a batched walk with a stack per lane, one pop per
# live lane an iteration, in the kernel's per-lane order and arithmetic
# ---------------------------------------------------------------------------


def _raise(err):
    msgs = [m for bit, m in _ERRORS.items() if err & bit]
    raise RuntimeError(f"trace_closest: malformed tree: {', '.join(msgs)}")


def _leaf_rows(rows, ox, oy, oz, dx, dy, dz, t_min, best_t):
    """Rows (k, L, 16) against k rays ((k, 1) each): (ok, t, u, v) (k, L),
    Moller-Trumbore in the reference kernel's order."""
    cols = rows[..., :10].unbind(-1)  # v0 / e1 / e2, original index
    big_det, inside, t, u, v = mt_uvt(*cols[:9], ox, oy, oz, dx, dy, dz)
    ok = big_det & inside & (t > t_min) & (t < best_t) & (cols[9] >= 0.0)
    return ok, t, u, v


def walk_plain(o, d, t_min, t_max, nodes, tris, leaf_size, visited=None, stack=None):
    """The plain version of the kernel. Returns (t (inf on miss), prim (-1),
    u, v, stats (N, 3) int32: node pops, leaf visits and rows tested per
    ray). `visited`, when given, is a pair of (N,) and (P,) bool tensors in
    which the walk marks the nodes popped and the rows tested; `stack` as
    for `closest`."""
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
                                     dx[ll, None], dy[ll, None], dz[ll, None],
                                     t_min[ll, None], best_t[ll, None])
            ok = ok & inside
            if visited is not None:
                visited[1][idx[inside]] = True
            stats[ll, 1] += 1
            stats[ll, 2] += lcnt.to(torch.int32)
            found = ok.any(dim=1)
            # the first row of least t: the kernel's in-order strict t < best_t
            j = torch.argmin(torch.where(ok, t, math.inf), dim=1, keepdim=True)
            fl = ll[found]
            best_t[fl] = t.gather(1, j)[found, 0]
            best_u[fl] = u.gather(1, j)[found, 0]
            best_v[fl] = v.gather(1, j)[found, 0]
            best_p[fl] = (lf[:, None] + j)[found, 0].to(torch.int32)
        lanes = torch.nonzero(sp > 0).squeeze(1)

    found = best_p >= 0
    return torch.where(found, best_t, math.inf), best_p, best_u, best_v, stats


def closest_plain(o, d, t_min, t_max, nodes, tris, leaf_size, stack=None):
    """Plain version of the kernel: (t, prim, u, v)."""
    return walk_plain(o, d, t_min, t_max, nodes, tris, leaf_size, stack=stack)[:4]


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
        lib.trace_closest.argtypes = ([ptr] * 5 + [i32, ptr, i32, i32, i32, i32] + [ptr] * 6
                                      + [i32, ptr])
        lib.trace_closest.restype = i32
        _LIB = lib
    return _LIB


def _check(o, d, t_min, t_max, nodes, tris, leaf_size):
    dev = o.device
    n = o.shape[0]
    for name, x, shape in (
        ("origin", o, (n, 3)), ("direction", d, (n, 3)),
        ("t_min", t_min, (n,)), ("t_max", t_max, (n,)),
        ("nodes", nodes, (nodes.shape[0], NODE_COLS)),
        ("tris", tris, (tris.shape[0], TRI_COLS)),
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
    if dev.type == "cuda" and (nodes.data_ptr() % 16 or tris.data_ptr() % 16):
        raise ValueError("the tables must be 16-byte aligned (float4 loads)")


def launch(o, d, t_min, t_max, nodes, tris, leaf_size, err, stats=None, stack=None):
    """Queue one kernel launch on the current stream and return (t, prim, u,
    v) without waiting. Errors of the walk are OR-ed into `err` (one int32
    on the card); `stats`, when given, is an (N, 3) int32 tensor that
    receives pops, leaf visits and rows tested per ray; `stack` as for
    `closest`."""
    global launches
    n, dev = o.shape[0], o.device
    stack = tree_stack(nodes, stack)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    rc = _library().trace_closest(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), nodes.data_ptr(),
        nodes.shape[0], tris.data_ptr(), tris.shape[0], leaf_size, stack, n, t.data_ptr(),
        prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        0 if stats is None else stats.data_ptr(), err.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trace kernel launch failed: CUDA error {rc}")
    launches += 1
    return t, prim, u, v


def closest(o, d, t_min, t_max, nodes, tris, leaf_size, stack=None):
    """Closest hit of each ray: (t (inf on miss), prim (the hit's row, -1 on
    miss), u, v). `stack`: the tree's stack bound when the caller has it
    (tree_stack), else it is computed from the node table."""
    _check(o, d, t_min, t_max, nodes, tris, leaf_size)
    if o.device.type == "cpu":
        return closest_plain(o, d, t_min, t_max, nodes, tris, leaf_size, stack)
    if o.shape[0] == 0:
        e = o.new_empty((0,))
        return e, torch.empty((0,), dtype=torch.int32, device=o.device), e, e
    err = torch.zeros((1,), dtype=torch.int32, device=o.device)
    out = launch(o, d, t_min, t_max, nodes, tris, leaf_size, err, stack=stack)
    code = int(err.item())  # waits for the launch
    if code:
        _raise(code)
    return out
