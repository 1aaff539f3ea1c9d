"""Convert an AkariRender binary `.mesh` file to Wavefront OBJ.

Counterpart of luisarender_tpu/tools/akr2obj.py, kept as the port's own
copy: LuisaRender's tools/akr2obj.py binary layout (length-prefixed name,
v/vn/vt arrays, iv/ivn/ivt index triples), argparse and buffered writing.
"""

from __future__ import annotations

import argparse
import struct

import numpy as np


def decode_akari_mesh(buf: bytes):
    """Parse the AkariRender mesh blob.

    Layout (all lengths little-endian u64):
      [len][name bytes][len][v f32x3][len][vn f32x3][len][vt f32x2]
      [len][iv u32x3][len][ivn u32x3][len][ivt u32x3]
    Returns (name, positions, normals, uvs, pos_idx, nrm_idx, uv_idx).
    """
    off = 0

    def take(fmt):
        nonlocal off
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, buf, off)
        off += size
        return vals

    (name_len,) = take("<Q")
    name = take(f"<{name_len}s")[0].decode("utf-8")

    def array(per, dtype, count_scale):
        (n,) = take("<Q")
        vals = take(f"<{n * count_scale}{per}")
        return np.asarray(vals, dtype).reshape(-1, count_scale)

    v = array("f", np.float32, 3)
    vn = array("f", np.float32, 3)
    vt = array("f", np.float32, 2)
    iv = array("I", np.uint32, 3)
    ivn = array("I", np.uint32, 3)
    ivt = array("I", np.uint32, 3)
    return name, v, vn, vt, iv, ivn, ivt


def akr_to_obj(mesh_path: str, obj_path: str | None = None) -> str:
    if obj_path is None:
        if not mesh_path.endswith(".mesh"):
            raise ValueError("expected a .mesh file")
        obj_path = mesh_path[: -len(".mesh")] + ".obj"
    with open(mesh_path, "rb") as f:
        name, v, vn, vt, iv, ivn, ivt = decode_akari_mesh(f.read())
    if not (iv.shape == ivn.shape == ivt.shape):
        raise ValueError("index array shapes disagree")
    lines = [f"o {name}"]
    lines += [f"v {x} {y} {z}" for x, y, z in v]
    lines += [f"vn {x} {y} {z}" for x, y, z in vn]
    lines += [f"vt {x} {y}" for x, y in vt]
    for (a, b, c), (na, nb, nc), (ta, tb, tc) in zip(
        iv + 1, ivn + 1, ivt + 1
    ):
        lines.append(f"f {a}/{ta}/{na} {b}/{tb}/{nb} {c}/{tc}/{nc}")
    with open(obj_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return obj_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mesh", help="input .mesh file")
    ap.add_argument("-o", "--output", default=None, help="output .obj path")
    args = ap.parse_args(argv)
    out = akr_to_obj(args.mesh, args.output)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
