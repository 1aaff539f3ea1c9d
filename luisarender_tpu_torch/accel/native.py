"""ctypes wrapper for the binned-SAH BVH builder (csrc/bvh_builder.cpp).

Counterpart of luisarender_tpu/accel/native.py. The source is compiled with
g++ at first use, with the reference's flags, into
`luisarender_tpu_torch/_build/` under a name that carries a hash of the
source and the flags. The library is written under a temporary name and
moved into place with `os.replace`, so a process building it never lets
another load half a file. There is no fallback: when g++ fails or the
library does not load, `build_bvh_sah` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from ..ops.build import BUILD_DIR, CSRC_DIR
from .bvh import BVHArrays

GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LIB = None


def library_path():
    src = (CSRC_DIR / "bvh_builder.cpp").read_bytes()
    key = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libbvh_builder-{key}.so"


def _load():
    """The built library, with its C signature declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, str(CSRC_DIR / "bvh_builder.cpp"), "-o", tmp],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed for bvh_builder.cpp:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.lr_build_bvh.restype = ctypes.c_int32
    lib.lr_build_bvh.argtypes = [
        f32p, ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_int32,
        f32p, f32p, i32p, i32p, i32p, i32p, ctypes.c_int64,
    ]
    _LIB = lib
    return _LIB


def build_bvh_sah(positions, triangles, leaf_size: int = 4) -> BVHArrays:
    """Binned-SAH build of the triangle soup (positions (V, 3), triangles
    (T, 3)); raises when the builder cannot be built or refuses the input."""
    lib = _load()
    verts = np.ascontiguousarray(positions, dtype=np.float32)
    tris = np.ascontiguousarray(triangles, dtype=np.int32)
    t = tris.shape[0]
    max_nodes = 2 * (t + 1)
    aabb_min = np.empty((max_nodes, 3), np.float32)
    aabb_max = np.empty((max_nodes, 3), np.float32)
    skip = np.empty(max_nodes, np.int32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    order = np.empty(t, np.int32)

    def ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    f32, i32 = ctypes.c_float, ctypes.c_int32
    n = lib.lr_build_bvh(
        ptr(verts, f32), verts.shape[0], ptr(tris, i32), t, leaf_size,
        ptr(aabb_min, f32), ptr(aabb_max, f32), ptr(skip, i32), ptr(first, i32),
        ptr(count, i32), ptr(order, i32), max_nodes,
    )
    if n < 0:
        raise ValueError(f"the SAH builder refused {t} triangles at leaf size {leaf_size}")
    return BVHArrays(
        aabb_min=aabb_min[:n].copy(),
        aabb_max=aabb_max[:n].copy(),
        skip=skip[:n].copy(),
        node_first=first[:n].copy(),
        node_count=count[:n].copy(),
        prim_index=order,
        leaf_size=leaf_size,
    )
