"""Minimal-dependency PLY mesh loader (ascii + binary little/big endian).

Counterpart of luisarender_tpu/utils/plyloader.py. PLY is the dominant
format of the Bitterli / PBRT scene repositories, so scenes load it directly,
without a conversion step. Supports:

- vertex properties x/y/z (+ nx/ny/nz normals, u/v | s/t | texture_u/v UVs);
  unknown per-vertex properties are parsed and skipped
- face property `vertex_indices`/`vertex_index` lists; polygons are
  fan-triangulated
- ascii 1.0, binary_little_endian 1.0, binary_big_endian 1.0

Returns the same (positions, triangles, normals, uvs) tuple as
utils/objloader.load_obj.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

_UV_NAMES = {"u": 0, "v": 1, "s": 0, "t": 1, "texture_u": 0, "texture_v": 1}


def load_ply(path):
    """-> (positions (V,3) f32, triangles (T,3) i32, normals|None, uvs|None)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype, list_count_dtype|None)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append(
                        (tokens[4], _TYPES[tokens[3]], _TYPES[tokens[2]])
                    )
                else:
                    elements[-1][2].append((tokens[2], _TYPES[tokens[1]], None))
            elif tokens[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
            raise ValueError(f"{path}: unsupported format {fmt}")
        endian = ">" if fmt == "binary_big_endian" else "<"

        data = {}
        for name, count, props in elements:
            if fmt == "ascii":
                data[name] = _read_ascii(f, count, props)
            else:
                data[name] = _read_binary(f, count, props, endian)

    verts = data.get("vertex", {})
    if not all(k in verts for k in ("x", "y", "z")):
        raise ValueError(f"{path}: vertex element missing x/y/z")
    p = np.stack(
        [verts["x"], verts["y"], verts["z"]], axis=-1
    ).astype(np.float32)
    n = None
    if all(k in verts for k in ("nx", "ny", "nz")):
        n = np.stack(
            [verts["nx"], verts["ny"], verts["nz"]], axis=-1
        ).astype(np.float32)
    uv = None
    uv_cols = {}
    for name, col in _UV_NAMES.items():
        if name in verts and col not in uv_cols:
            uv_cols[col] = verts[name]
    if 0 in uv_cols and 1 in uv_cols:
        uv = np.stack([uv_cols[0], uv_cols[1]], axis=-1).astype(np.float32)

    tris = []
    faces = data.get("face", {})
    idx_lists = faces.get("vertex_indices", faces.get("vertex_index"))
    if idx_lists is None:
        t = np.zeros((0, 3), np.int32)
    else:
        for poly in idx_lists:
            for k in range(1, len(poly) - 1):
                tris.append((poly[0], poly[k], poly[k + 1]))
        t = np.asarray(tris, np.int32).reshape(-1, 3)
    return p, t, n, uv


def _read_ascii(f, count, props):
    cols: dict = {name: [] for name, _, _ in props}
    for _ in range(count):
        tokens = f.readline().split()
        i = 0
        for name, dtype, list_dtype in props:
            if list_dtype is not None:
                ln = int(tokens[i])
                i += 1
                vals = [int(float(x)) for x in tokens[i:i + ln]]
                i += ln
                cols[name].append(vals)
            else:
                cols[name].append(float(tokens[i]))
                i += 1
    return {
        k: v if isinstance(v[0], list) else np.asarray(v)
        for k, v in cols.items()
        if v
    }


def _read_binary(f, count, props, endian):
    fixed = all(ld is None for _, _, ld in props)
    if fixed:
        dt = np.dtype([(name, endian + t) for name, t, _ in props])
        raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
        return {name: np.ascontiguousarray(raw[name]) for name, _, _ in props}
    # variable-length rows: fast path for the overwhelmingly common case of
    # ONE list property with uniform length (peek the first row), else a
    # per-row python parse
    cols: dict = {name: [] for name, _, _ in props}
    pos0 = f.tell()
    if len(props) == 1 and props[0][2] is not None:
        name, vt, lt = props[0]
        ldt = np.dtype(endian + lt)
        vdt = np.dtype(endian + vt)
        first = np.frombuffer(f.read(ldt.itemsize), ldt)[0]
        row_bytes = ldt.itemsize + int(first) * vdt.itemsize
        f.seek(pos0)
        raw = f.read(row_bytes * count)
        if len(raw) == row_bytes * count:
            rows = np.frombuffer(raw, np.uint8).reshape(count, row_bytes)
            counts = rows[:, : ldt.itemsize].copy().view(ldt).reshape(-1)
            if np.all(counts == first):
                vals = (
                    rows[:, ldt.itemsize:].copy().view(vdt)
                    .reshape(count, int(first)).astype(np.int64)
                )
                return {name: [list(r) for r in vals]}
        f.seek(pos0)
    for _ in range(count):
        for name, vt, lt in props:
            if lt is not None:
                ldt = np.dtype(endian + lt)
                ln = int(np.frombuffer(f.read(ldt.itemsize), ldt)[0])
                vdt = np.dtype(endian + vt)
                vals = np.frombuffer(f.read(vdt.itemsize * ln), vdt)
                cols[name].append([int(x) for x in vals])
            else:
                vdt = np.dtype(endian + vt)
                cols[name].append(
                    float(np.frombuffer(f.read(vdt.itemsize), vdt)[0])
                )
    return {
        k: v if isinstance(v[0], list) else np.asarray(v)
        for k, v in cols.items()
        if v
    }
