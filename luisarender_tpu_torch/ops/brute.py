"""Brute-force closest-hit / any-hit ray-triangle intersection.

Counterpart of luisarender_tpu/ops/brute_pallas.py. On CUDA tensors the
wrappers launch the hand-written kernels of csrc/brute.cu (live lanes
compacted in shared memory, the table staged there; the source says why).
On CPU tensors they run the plain PyTorch versions below, which repeat the
kernels' arithmetic in the same order; the CPU tests hold those against the
Pallas kernels in interpret mode. There is no fallback: a CUDA tensor
launches the kernel or raises. `closest` and `any_hit` are
torch.autograd.Functions that pass no gradient (ops/nograd.py), as the
reference's custom VJP passes zeros, on either device.

Table: (P, 16) float32 rows, P <= MAX_TRIS; cols 0-8 v0/e1/e2, 9 valid
(0 = padding row), 10 opaque (blocks shadow rays).

`closest_launches` / `any_launches` count kernel launches, so that a run
can show its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .nograd import no_grad_entry

MAX_TRIS = 512
TRI_COLS = 16
_T_MAX_CLAMP = 3e38

closest_launches = 0
any_launches = 0

# the kernels' optional per-launch counters (csrc/brute.cu CTR_*): live rays,
# their row tests, 32 x the row steps of the warps that traced, and 32 x the
# row steps where some lane of the warp went past the u test
COUNTERS = ("rays", "tests", "slots", "deep_slots")


def make_tri_table(tri_v0, tri_e1, tri_e2, prim_index, tri_opaque):
    """(P, 16) kernel table from the scene's triangle arrays."""
    p = tri_v0.shape[0]
    valid = (prim_index >= 0).to(torch.float32)[:, None]
    opaque = tri_opaque.to(torch.float32)[:, None]
    pad = tri_v0.new_zeros((p, TRI_COLS - 11))
    return torch.cat([tri_v0, tri_e1, tri_e2, valid, opaque, pad], dim=-1).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions: a loop over rows, vectorised over rays, in the
# kernels' operation order
# ---------------------------------------------------------------------------


def mt_uvt(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx, dy, dz):
    """Moller-Trumbore of rays against triangles (broadcasting tensors), in
    the reference's order of operations, shared by every plain version and
    the (u, v) recompute of scene/geometry.py: (big_det, inside, t, u, v).
    big_det is |det| > 1e-12 (else 1 / det is taken as 0); inside is
    u, v >= 0 and u + v <= 1. The t-range test is the caller's."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    big_det = torch.abs(det) > 1e-12
    inv_det = torch.where(big_det, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return big_det, (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0), t, u, v


def moller_trumbore(r, ox, oy, oz, dx, dy, dz):
    """Table row(s) r (16 tensors: one row's 0-dim entries, or (P,) columns
    against (N, 1) rays) against the rays. Returns (ok, t, u, v); ok
    excludes the t-range test."""
    _, inside, t, u, v = mt_uvt(*r[:9], ox, oy, oz, dx, dy, dz)
    return inside & (r[9] > 0.0), t, u, v


def table_rows(table):
    """Rows of a (P, 16) table as tuples of 0-dim tensors (no host sync)."""
    return [row.unbind(0) for row in table.unbind(0)]


def closest_plain(o, d, t_min, t_max, table):
    """Plain version of the closest-hit kernel: (t, slot, u, v)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    best_t = torch.where(t_max < _T_MAX_CLAMP, t_max, _T_MAX_CLAMP)
    best_s = torch.full(t_min.shape, -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros_like(t_min)
    best_v = torch.zeros_like(t_min)
    for j, r in enumerate(table_rows(table)):
        ok, t, u, v = moller_trumbore(r, ox, oy, oz, dx, dy, dz)
        ok = ok & (t > t_min) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_s = torch.where(ok, j, best_s)
        best_u = torch.where(ok, u, best_u)
        best_v = torch.where(ok, v, best_v)
    found = best_s >= 0
    return torch.where(found, best_t, math.inf), best_s, best_u, best_v


def any_plain(o, d, t_min, t_max, table):
    """Plain version of the any-hit kernel: bool occlusion per ray."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    occ = torch.zeros(t_min.shape, dtype=torch.bool, device=o.device)
    for r in table_rows(table):
        ok, t, _, _ = moller_trumbore(r, ox, oy, oz, dx, dy, dz)
        occ = occ | (ok & (t > t_min) & (t < t_max) & (r[10] > 0.0))
    return occ


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


_LIB = None


def _library():
    """The built kernel library, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("brute")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # outputs and the lane counters; device and stream
        lib.brute_closest.argtypes = [ptr] * 5 + [i32, i32] + [ptr] * 5 + [i32, ptr]
        lib.brute_closest.restype = i32
        lib.brute_any.argtypes = [ptr] * 5 + [i32, i32] + [ptr] * 2 + [i32, ptr]
        lib.brute_any.restype = i32
        lib.brute_counters.restype = i32
        if lib.brute_counters() != len(COUNTERS):
            raise RuntimeError(f"csrc/brute.cu keeps {lib.brute_counters()} counters, "
                               f"ops/brute.py names {len(COUNTERS)}")
        _LIB = lib
    return _LIB


def _check(o, d, t_min, t_max, table, counters=None):
    dev = o.device
    n = o.shape[0]
    for name, x, shape in (
        ("origin", o, (n, 3)), ("direction", d, (n, 3)),
        ("t_min", t_min, (n,)), ("t_max", t_max, (n,)),
        ("table", table, (table.shape[0], TRI_COLS)),
    ):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, origin on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.shape[0] > MAX_TRIS:
        raise ValueError(
            f"brute-force table has {table.shape[0]} rows; at most {MAX_TRIS}"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if counters is not None and (dev.type != "cuda" or counters.device != dev
                                 or counters.dtype != torch.int64
                                 or counters.shape != (len(COUNTERS),)
                                 or not counters.is_contiguous()):
        raise ValueError(f"counters must be a contiguous int64 ({len(COUNTERS)},) "
                         f"tensor on the rays' CUDA device")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@no_grad_entry
def closest(o, d, t_min, t_max, table, counters=None):
    """Closest hit of each ray: (t (inf on miss), slot (-1 on miss), u, v).
    `counters`, on the card only, is an int64 tensor of len(COUNTERS) that
    the kernel adds its lane counters to."""
    global closest_launches
    _check(o, d, t_min, t_max, table, counters)
    if o.device.type == "cpu":
        return closest_plain(o, d, t_min, t_max, table)
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    slot = torch.empty((n,), dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:
        return t, slot, u, v
    lib = _library()
    err = lib.brute_closest(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        table.data_ptr(), n, table.shape[0],
        t.data_ptr(), slot.data_ptr(), u.data_ptr(), v.data_ptr(),
        0 if counters is None else counters.data_ptr(), o.device.index or 0,
        _stream(o.device),
    )
    _raise_on(err, "brute_closest")
    closest_launches += 1
    return t, slot, u, v


@no_grad_entry
def any_hit(o, d, t_min, t_max, table, counters=None):
    """Occlusion of each ray by any valid opaque row within (t_min, t_max),
    as bool; `counters` as for closest."""
    global any_launches
    _check(o, d, t_min, t_max, table, counters)
    if o.device.type == "cpu":
        return any_plain(o, d, t_min, t_max, table)
    n = o.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.device)  # the kernel writes 0 / 1
    if n == 0:
        return occ
    lib = _library()
    err = lib.brute_any(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        table.data_ptr(), n, table.shape[0], occ.data_ptr(),
        0 if counters is None else counters.data_ptr(), o.device.index or 0,
        _stream(o.device),
    )
    _raise_on(err, "brute_any")
    any_launches += 1
    return occ
