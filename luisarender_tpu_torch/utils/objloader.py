"""Minimal Wavefront OBJ loader (positions, normals, uvs, triangles).

Counterpart of luisarender_tpu/utils/objloader.py. Supports v/vn/vt/f
records, polygon fan triangulation, negative indices, and the v/vt/vn index
forms. Vertices are de-duplicated per (v, vt, vn) triple so indexed
attributes stay consistent; zero-length authored normals fall back to the
area-weighted vertex normals.
"""

from __future__ import annotations

import numpy as np


def load_obj(path):
    positions, normals, uvs = [], [], []
    out_pos, out_nrm, out_uv = [], [], []
    vertex_cache: dict = {}
    triangles = []
    any_normal = False
    any_uv = False

    def resolve(idx, n):
        i = int(idx)
        return i - 1 if i > 0 else n + i

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] not in "vf":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vn":
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                uvs.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif tag == "f":
                corner_ids = []
                for spec in parts[1:]:
                    if spec in vertex_cache:
                        corner_ids.append(vertex_cache[spec])
                        continue
                    comps = spec.split("/")
                    vi = resolve(comps[0], len(positions))
                    ti = (
                        resolve(comps[1], len(uvs))
                        if len(comps) > 1 and comps[1]
                        else -1
                    )
                    ni = (
                        resolve(comps[2], len(normals))
                        if len(comps) > 2 and comps[2]
                        else -1
                    )
                    new_id = len(out_pos)
                    out_pos.append(positions[vi])
                    out_uv.append(uvs[ti] if ti >= 0 else [0.0, 0.0])
                    out_nrm.append(normals[ni] if ni >= 0 else [0.0, 0.0, 0.0])
                    vertex_cache[spec] = new_id
                    corner_ids.append(new_id)
                for k in range(1, len(corner_ids) - 1):
                    triangles.append(
                        [corner_ids[0], corner_ids[k], corner_ids[k + 1]]
                    )

    any_normal = len(normals) > 0
    any_uv = len(uvs) > 0
    p = np.asarray(out_pos, dtype=np.float32)
    t = np.asarray(triangles, dtype=np.int32)
    n = np.asarray(out_nrm, dtype=np.float32) if any_normal else None
    uv = np.asarray(out_uv, dtype=np.float32) if any_uv else None
    if n is not None:
        bad = np.linalg.norm(n, axis=-1) < 1e-6
        if bad.any():
            from ..shapes.base import compute_vertex_normals

            fallback = compute_vertex_normals(p, t)
            n = np.where(bad[:, None], fallback, n)
    return p, t, n, uv
