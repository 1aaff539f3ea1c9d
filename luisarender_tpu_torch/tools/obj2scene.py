"""OBJ+MTL -> JSON scene converter.

Counterpart of luisarender_tpu/tools/obj2scene.py, kept as the port's own
copy: an analogue of LuisaRender's src/apps/export.cpp (an Assimp-based
glTF -> LuisaRender-JSON converter with Disney material mapping) whose
importer side is Wavefront OBJ/MTL, the format the mesh plugin and
LuisaRender's tools/ scripts exchange.

    python -m luisarender_tpu_torch.tools.obj2scene model.obj -o scene.json

Maps MTL materials to Disney surfaces: Kd -> color (map_Kd -> image texture),
Ks/Ns -> roughness, d/Tr -> alpha, Ke -> area light emission.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def parse_mtl(path: Path) -> dict:
    materials = {}
    cur = None
    if not path.exists():
        return materials
    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        key = parts[0].lower()
        if key == "newmtl":
            cur = parts[1]
            materials[cur] = {}
        elif cur is None:
            continue
        elif key in ("kd", "ks", "ke"):
            materials[cur][key] = [float(x) for x in parts[1:4]]
        elif key in ("ns", "d", "tr", "ni"):
            materials[cur][key] = float(parts[1])
        elif key == "map_kd":
            materials[cur]["map_kd"] = parts[-1]
    return materials


def mtl_to_surface(name: str, m: dict, base_dir: Path) -> dict:
    """Disney-surface JSON for an MTL material (export.cpp:77-260 mapping)."""
    prop = {}
    if "map_kd" in m:
        prop["color"] = {
            "impl": "image",
            "prop": {"file": str(base_dir / m["map_kd"])},
        }
    else:
        prop["color"] = {
            "impl": "constant",
            "prop": {"v": m.get("kd", [0.8, 0.8, 0.8])},
        }
    ns = m.get("ns", 10.0)
    # Blinn-Phong exponent -> roughness (standard sqrt(2/(ns+2)) mapping)
    roughness = min(max((2.0 / (ns + 2.0)) ** 0.5, 0.03), 1.0)
    prop["roughness"] = {"impl": "constant", "prop": {"v": [roughness]}}
    ks = m.get("ks", [0.0, 0.0, 0.0])
    if max(ks) > 0.5:
        prop["metallic"] = {"impl": "constant", "prop": {"v": [min(max(ks), 1.0)]}}
    if m.get("ni", 1.0) > 1.0 and m.get("d", 1.0) < 1.0:
        prop["specular_trans"] = {
            "impl": "constant",
            "prop": {"v": [1.0 - m.get("d", 1.0)]},
        }
        prop["eta"] = {"impl": "constant", "prop": {"v": [m["ni"]]}}
    return {"type": "Surface", "impl": "disney", "prop": prop}


def split_obj_by_material(obj_path: Path, out_dir: Path):
    """Split the OBJ into per-material OBJ files (our mesh plugin binds one
    surface per shape). Returns [(mesh_file, material_name, emissive_ke)]."""
    verts, texs, norms = [], [], []
    groups: dict = {}
    cur_mtl = "__default__"
    mtl_file = None
    for line in obj_path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        if tag == "mtllib":
            mtl_file = parts[1]
        elif tag == "usemtl":
            cur_mtl = parts[1]
        elif tag == "v":
            verts.append(line)
        elif tag == "vt":
            texs.append(line)
        elif tag == "vn":
            norms.append(line)
        elif tag == "f":
            groups.setdefault(cur_mtl, []).append(line)
    out = []
    for mtl, faces in groups.items():
        safe = "".join(ch if ch.isalnum() else "_" for ch in mtl)
        mesh_file = out_dir / f"{obj_path.stem}_{safe}.obj"
        with open(mesh_file, "w") as f:
            f.write("\n".join(verts + texs + norms + faces))
        out.append((mesh_file, mtl))
    return out, mtl_file


def main(argv=None):
    parser = argparse.ArgumentParser(description="OBJ+MTL -> JSON scene")
    parser.add_argument("obj", help="input .obj file")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--spp", type=int, default=256)
    parser.add_argument("--resolution", type=int, nargs=2, default=[1280, 720])
    args = parser.parse_args(argv)

    obj_path = Path(args.obj)
    out_path = Path(args.output or obj_path.with_suffix(".json"))
    out_dir = out_path.parent
    out_dir.mkdir(parents=True, exist_ok=True)

    pieces, mtl_file = split_obj_by_material(obj_path, out_dir)
    materials = (
        parse_mtl(obj_path.parent / mtl_file) if mtl_file else {}
    )

    scene: dict = {}
    shapes = []
    for mesh_file, mtl_name in pieces:
        m = materials.get(mtl_name, {})
        surf_key = f"mat_{mtl_name}"
        if surf_key not in scene:
            scene[surf_key] = mtl_to_surface(mtl_name, m, obj_path.parent)
        shape = {
            "impl": "mesh",
            "prop": {
                "file": str(mesh_file),
                "surface": f"@{surf_key}",
            },
        }
        ke = m.get("ke", [0, 0, 0])
        if max(ke) > 0:
            shape["prop"]["light"] = {
                "impl": "diffuse",
                "prop": {"emission": {"impl": "constant", "prop": {"v": ke}}},
            }
        shapes.append(shape)

    scene["render"] = {
        "cameras": [
            {
                "impl": "pinhole",
                "prop": {
                    "fov": 40.0,
                    "spp": args.spp,
                    "file": str(out_path.with_suffix(".exr")),
                    "film": {
                        "impl": "color",
                        "prop": {"resolution": list(args.resolution)},
                    },
                    "transform": {
                        "impl": "view",
                        "prop": {"origin": [0, 1, 4], "front": [0, 0, -1]},
                    },
                },
            }
        ],
        "integrator": {"impl": "megapath", "prop": {"depth": 8}},
        "environment": {
            "impl": "spherical",
            "prop": {"emission": {"impl": "constant", "prop": {"v": [0.5, 0.6, 0.8]}}},
        },
        "shapes": shapes,
    }
    out_path.write_text(json.dumps(scene, indent=1))
    print(out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
