"""Report unique vs duplicated vertex/face counts of OBJ files.

The port's copy of luisarender_tpu/tools/obj_analyse.py, a counterpart of
LuisaRender's tools/obj-analyse.py (which, notably, ships
with a Windows-only `msilib` import and 1-based face indices resolved
against raw file LINES — a bug for files with comments). This version
resolves indices against the parsed vertex list (handling negative OBJ
indices too) and dedupes faces by their vertex coordinate triples.
"""

from __future__ import annotations

import argparse
import os


def analyse_obj(path, vertex_set=None, face_set=None):
    """Returns (unique_vertices, unique_faces, total_vertices, total_faces);
    pass shared sets to aggregate across files."""
    vertex_set = set() if vertex_set is None else vertex_set
    face_set = set() if face_set is None else face_set
    v_total = f_total = 0
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                coords = tuple(line.split()[1:4])
                verts.append(coords)
                vertex_set.add(coords)
                v_total += 1
            elif line.startswith("f "):
                refs = line.split()[1:]
                idx = []
                for r in refs:
                    i = int(r.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                # triangulate fans (the reference only handles quads)
                for k in range(1, len(idx) - 1):
                    tri = (idx[0], idx[k], idx[k + 1])
                    face_set.add(tuple(verts[i] for i in tri))
                    f_total += 1
    return len(vertex_set), len(face_set), v_total, f_total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="an .obj file or a directory of them")
    args = ap.parse_args(argv)
    vertex_set, face_set = set(), set()
    v_total = f_total = 0
    if os.path.isfile(args.path):
        files = [args.path]
    else:
        files = sorted(
            os.path.join(args.path, f)
            for f in os.listdir(args.path)
            if f.endswith(".obj")
        )
        print(len(files))
    for f in files:
        _, _, vt, ft = analyse_obj(f, vertex_set, face_set)
        v_total += vt
        f_total += ft
    print(f"Vertex count: {len(vertex_set)}")
    print(f"Face count: {len(face_set)}")
    print(f"Vertex duplicated count: {v_total}")
    print(f"Face duplicated count: {f_total}")


if __name__ == "__main__":
    main()
