"""Split a multi-group wavefront OBJ into one OBJ per group/material.

The port's copy of luisarender_tpu/tools/split_obj.py, a counterpart of
LuisaRender's tools/split_obj.py (behavioral parity: one
output mesh per `g`/`o`/`usemtl` run, vertices re-indexed per output), built
on a single-pass parser that keeps only the vertex ranges each group
references.

Usage:  python -m luisarender_tpu_torch.tools.split_obj scene.obj [out_dir]
Library: split_obj(path, out_dir) -> {name: out_path}
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path


def _parse(path):
    """One pass: vertex/uv/normal line lists + {group: [face index triples]}."""
    v, vt, vn = [], [], []
    groups: dict[str, list] = {}
    current = None
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                v.append(line)
            elif line.startswith("vt "):
                vt.append(line)
            elif line.startswith("vn "):
                vn.append(line)
            elif line.split(" ", 1)[0] in ("g", "o", "usemtl"):
                tag = ".".join(line.split()[1:]) or "default"
                current = f"{len(groups):05d}.{tag}"
                groups.setdefault(current, [])
            elif line.startswith("f "):
                if current is None:
                    current = "00000.default"
                    groups[current] = []
                face = []
                for corner in line.split()[1:]:
                    parts = (corner.split("/") + ["", ""])[:3]
                    face.append(
                        tuple(int(p) if p else 0 for p in parts)
                    )
                groups[current].append(face)
    return v, vt, vn, groups


def _emit_group(out_path, v, vt, vn, faces):
    """Write one group's OBJ with densely re-indexed v/vt/vn."""
    remap = [{}, {}, {}]  # old 1-based -> new 1-based, per index kind
    order = [[], [], []]

    def new_index(kind, old):
        if old == 0:
            return 0
        m = remap[kind]
        if old not in m:
            m[old] = len(m) + 1
            order[kind].append(old)
        return m[old]

    out_faces = []
    for face in faces:
        out_faces.append(
            [tuple(new_index(k, idx) for k, idx in enumerate(c)) for c in face]
        )
    with open(out_path, "w") as f:
        for src, kind in ((v, 0), (vt, 1), (vn, 2)):
            for old in order[kind]:
                f.write(src[old - 1])
        f.write("g mesh\n")
        for face in out_faces:
            f.write("f")
            for iv, it, inr in face:
                if inr and it:
                    f.write(f" {iv}/{it}/{inr}")
                elif inr:
                    f.write(f" {iv}//{inr}")
                elif it:
                    f.write(f" {iv}/{it}")
                else:
                    f.write(f" {iv}")
            f.write("\n")


def split_obj(path, out_dir=None) -> dict:
    path = Path(path)
    out_dir = Path(out_dir) if out_dir else path.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    v, vt, vn, groups = _parse(path)
    out = {}
    for name, faces in groups.items():
        if not faces:
            continue
        dst = out_dir / f"{path.stem}.{name}.obj"
        _emit_group(dst, v, vt, vn, faces)
        out[name] = str(dst)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("obj", help="input .obj with multiple groups")
    ap.add_argument("out_dir", nargs="?", help="output directory")
    args = ap.parse_args(argv)
    for name, dst in split_obj(args.obj, args.out_dir).items():
        print(f"{name} -> {dst}")


if __name__ == "__main__":
    main()
