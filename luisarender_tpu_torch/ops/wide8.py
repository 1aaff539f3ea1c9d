"""Closest-hit / any-hit traversal of the 8-wide cluster tree with
Moller-Trumbore triangle tests: the opt-in `LR_WIDE8=1` route for scenes
above the brute-force size.

Counterpart of luisarender_tpu/ops/wide8_pallas.py. It walks the 8-wide
tree of ops/subpacket.py (slab8 / meta8), re-tests each leaf cluster's box
(`build_cluster_boxes`, the reference's host code) against the ray's
current best t, and tests the cluster's rows of the triangle blocks of
ops/cluster.py as the cluster kernel does: rows in order, a strict
t < best_t, exact (u, v). Its hits equal the cluster kernel's except for
exact ties across clusters.

On CUDA tensors `closest` / `any_hit` launch csrc/wide8.cu (a lane a ray
walking the tree, each warp testing its lanes' leaf clusters together; the
source says why). On CPU tensors they run the plain PyTorch version below,
which walks the same tree in the kernel's per-lane order and arithmetic.
There is no fallback: a CUDA tensor launches the kernel or raises. Both
size the per-ray stack from the tree (ops/subpacket.py resolve_stack8); the
kernel is built with the stacks of ops/subpacket.py STACKS8 and a launch
takes the least that holds the bound (`stack_build`). A malformed tree
raises in both. `closest` and `any_hit` are torch.autograd.Functions that
pass no gradient (ops/nograd.py), as the reference's custom VJP passes
zeros.

The reference's wrapper sorts launches of at least 32,768 rays into
coherent packets first (wide8_pallas.py:340-352, MIN_SORT_RAYS).
ops/subpacket.py `coherence_order` is that order, over the scene's bounds
in meta8's row 0. Each ray's walk is its own, so the outputs are the same
in either order.
On the H100 the kernel is slower on sorted closest-hit rays and gains 2-4
us on sorted shadow rays, against ~0.6 ms of device time for the sort
itself (PERF.md), so `closest` / `any_hit` launch in caller order.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from .cluster import CLUSTER, COUNTERS as WALK_COUNTERS, TRI_COLS, leaf_blocks_plain, slab
from .nograd import no_grad_entry
from .subpacket import (STACKS8, check_bvh8, check_counters, raise_walk_error, resolve_stack8,
                        stack_build, walk8_plain)

# the route is taken only when asked for, as in the reference
ENABLED = os.environ.get("LR_WIDE8", "0") != "0"
CBOX_COLS = 8
# the kernel's optional per-launch counters (csrc/trace_common.cuh CTR_*,
# then csrc/wide8.cu's): the cluster kernel's, and the pending leaves that
# the box re-test dropped
COUNTERS = WALK_COUNTERS + ("culled",)

closest_launches = 0
any_launches = 0


def build_cluster_boxes(node_table: np.ndarray) -> np.ndarray:
    """(C, 8) float32 box of each cluster (min xyz, max xyz, 0, 0) from the
    cluster tree's leaf rows (N, 8)."""
    node = np.asarray(node_table, np.float32)
    first = node[:, 7].astype(np.int64)
    leaf = first >= 0
    c = int(first[leaf].max()) + 1 if leaf.any() else 1
    boxes = np.zeros((c, 8), np.float32)
    boxes[first[leaf], 0:3] = node[leaf, 0:3]
    boxes[first[leaf], 3:6] = node[leaf, 3:6]
    return boxes


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _mt_leaf(cboxes, tris, any_hit):
    blk12 = tris[:, :12, :]

    def leaf_test(st, lanes, blks, ray):
        ox, oy, oz, dx, dy, dz, ix, iy, iz, t_min = ray
        # the cluster's box (read as a node row: columns 0-5) against the
        # ray's current best t
        alive = slab(cboxes[blks], ox[lanes], oy[lanes], oz[lanes], ix[lanes],
                     iy[lanes], iz[lanes], t_min[lanes], st.best_t[lanes])
        lanes, blks = lanes[alive], blks[alive]
        st.mark_clusters(blks)
        hit_l = leaf_blocks_plain(blk12, lanes, blks, (ox, oy, oz, dx, dy, dz, t_min),
                                 (st.best_t, st.best_s, st.best_u, st.best_v), st.stats,
                                 any_hit)
        st.occ[hit_l] = True
    return leaf_test


def wide8_plain(o, d, t_min, t_max, slab8, meta8, cboxes, tris, any_hit, visited=None,
                stack=None):
    """The plain version of both kernel modes: the WalkState of
    ops/subpacket.py (stats: node pops, clusters tested after the box
    re-test, rows tested)."""
    name = "wide8_any" if any_hit else "wide8_closest"
    return walk8_plain(o, d, t_min, t_max, slab8, meta8, tris.shape[0],
                       _mt_leaf(cboxes, tris, any_hit), any_hit, name,
                       resolve_stack8(meta8, stack, name), visited)


def closest_plain(o, d, t_min, t_max, slab8, meta8, cboxes, tris, stack=None):
    """Plain version of the closest-hit kernel: (t, slot, u, v)."""
    st = wide8_plain(o, d, t_min, t_max, slab8, meta8, cboxes, tris, False, stack=stack)
    found = st.best_s >= 0
    return torch.where(found, st.best_t, math.inf), st.best_s, st.best_u, st.best_v


def any_plain(o, d, t_min, t_max, slab8, meta8, cboxes, tris, stack=None):
    """Plain version of the any-hit kernel: bool occlusion per ray."""
    return wide8_plain(o, d, t_min, t_max, slab8, meta8, cboxes, tris, True,
                       stack=stack).occ


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("wide8")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        args = [ptr] * 6 + [i32, ptr, ptr, i32, i32, i32]
        # outputs, stats, counters and the error word; device and stream
        lib.wide8_closest.argtypes = args + [ptr] * 7 + [i32, ptr]
        lib.wide8_closest.restype = i32
        lib.wide8_any.argtypes = args + [ptr] * 4 + [i32, ptr]
        lib.wide8_any.restype = i32
        lib.wide8_counters.restype = i32
        lib.wide8_stack_build.argtypes = [i32]
        lib.wide8_stack_build.restype = i32
        if lib.wide8_counters() != len(COUNTERS):
            raise RuntimeError(f"csrc/wide8.cu keeps {lib.wide8_counters()} counters, "
                               f"ops/wide8.py names {len(COUNTERS)}")
        for bound in (1, STACKS8[0], STACKS8[0] + 1, STACKS8[-1], STACKS8[-1] + 1):
            if lib.wide8_stack_build(bound) != stack_build(bound):
                raise RuntimeError(f"csrc/wide8.cu takes a {lib.wide8_stack_build(bound)}-entry "
                                   f"stack for a bound of {bound}, ops/subpacket.py STACKS8 "
                                   f"{stack_build(bound)}")
        _LIB = lib
    return _LIB


def _check(o, d, t_min, t_max, slab8, meta8, cboxes, tris):
    c = tris.shape[0]
    check_bvh8(o, d, t_min, t_max, slab8, meta8,
               (("tris", tris, (c, TRI_COLS, CLUSTER)), ("cboxes", cboxes, (c, CBOX_COLS))))
    if o.device.type == "cuda" and cboxes.data_ptr() % 16:
        raise ValueError("cboxes must be 16-byte aligned (float4 loads)")


def launch(o, d, t_min, t_max, slab8, meta8, cboxes, tris, any_hit, err, stats=None,
           stack=None, counters=None):
    """Queue one kernel launch on the current stream and return its outputs
    without waiting: closest (t, slot, u, v) or any-hit occlusion (int32).
    The rays are walked in the order given. Errors of the walk are OR-ed
    into `err` (one int32 on the card); `stats`, when given, is an (N, 3)
    int32 tensor that receives the walk's counts (as WalkState.stats);
    `stack`, the tree's stack bound (ops/subpacket.py resolve_stack8);
    `counters`, a contiguous int64 tensor of len(COUNTERS) that the kernel
    adds its lane counters to."""
    global closest_launches, any_launches
    n, dev = o.shape[0], o.device
    check_counters(counters, len(COUNTERS), dev)
    lib = _library()
    stack = resolve_stack8(meta8, stack, "wide8_any" if any_hit else "wide8_closest")
    common = (o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
              slab8.data_ptr(), meta8.data_ptr(), slab8.shape[0], cboxes.data_ptr(),
              tris.data_ptr(), tris.shape[0], stack, n)
    tail = (0 if stats is None else stats.data_ptr(),
            0 if counters is None else counters.data_ptr(), err.data_ptr(), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    if any_hit:
        occ = torch.empty((n,), dtype=torch.int32, device=dev)
        rc = lib.wide8_any(*common, occ.data_ptr(), *tail)
        out = occ
    else:
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        slot = torch.empty((n,), dtype=torch.int32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        rc = lib.wide8_closest(*common, t.data_ptr(), slot.data_ptr(), u.data_ptr(),
                               v.data_ptr(), *tail)
        out = (t, slot, u, v)
    if rc != 0:
        raise RuntimeError(f"wide8 kernel launch failed: CUDA error {rc}")
    if any_hit:
        any_launches += 1
    else:
        closest_launches += 1
    return out


def _run(o, d, t_min, t_max, slab8, meta8, cboxes, tris, any_hit, stack):
    err = torch.zeros((1,), dtype=torch.int32, device=o.device)
    out = launch(o, d, t_min, t_max, slab8, meta8, cboxes, tris, any_hit, err, stack=stack)
    code = int(err.item())  # waits for the launch
    if code:
        raise_walk_error(code, "wide8_any" if any_hit else "wide8_closest")
    return out


@no_grad_entry
def closest(o, d, t_min, t_max, slab8, meta8, cboxes, tris, stack=None):
    """Closest hit of each ray: (t (inf on miss), slot (-1 on miss), u, v).
    `stack`: the tree's stack bound when the caller has it (ScenePlan
    .bvh8_stack), else it is computed from meta8."""
    _check(o, d, t_min, t_max, slab8, meta8, cboxes, tris)
    if o.device.type == "cpu":
        return closest_plain(o, d, t_min, t_max, slab8, meta8, cboxes, tris, stack)
    if o.shape[0] == 0:
        e = o.new_empty((0,))
        return e, torch.empty((0,), dtype=torch.int32, device=o.device), e, e
    return _run(o, d, t_min, t_max, slab8, meta8, cboxes, tris, False, stack)


@no_grad_entry
def any_hit(o, d, t_min, t_max, slab8, meta8, cboxes, tris, stack=None):
    """Occlusion of each ray by any valid opaque triangle within
    (t_min, t_max); `stack` as for `closest`."""
    _check(o, d, t_min, t_max, slab8, meta8, cboxes, tris)
    if o.device.type == "cpu":
        return any_plain(o, d, t_min, t_max, slab8, meta8, cboxes, tris, stack)
    if o.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=o.device)
    return _run(o, d, t_min, t_max, slab8, meta8, cboxes, tris, True, stack) > 0
