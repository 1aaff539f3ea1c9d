"""Disney-research (Moana-island style) scene project -> our scene JSON.

The port's copy of luisarender_tpu/tools/disney2scene.py, a counterpart of
LuisaRender's tools/disney2luisa.py, re-targeted at this
renderer's schema. A Disney project directory looks like:

    project/
      json/cameras/*.json          {name, eye, look, up, fov (horizontal,
                                    degrees), ratio}
      json/lights/lights.json      {name: {type: quad|dome, translationMatrix
                                    (column-major 4x4), exposure, color,
                                    width?, height?}}
      json/<element>/<element>.json  {matFile, geomObjFile,
                                      instancedCopies?: {name:
                                      {transformMatrix}}, transformMatrix}
      json/<element>/materials.json  {name: {type: solid|thin, baseColor,
                                      metallic, ior, roughness, specularTint,
                                      anisotropic, sheen, sheenTint,
                                      clearcoat, clearcoatGloss, specTrans,
                                      flatness?, diffTrans?, assignment:
                                      [obj-group glob patterns]}}
      obj files referenced by geomObjFile (groups named per assignment)

Mapping: cameras -> pinhole (horizontal fov converted to vertical), quad
lights -> emissive unit-quad mesh under the light transform, dome lights ->
constant spherical environment, materials -> our `disney` surface, geometry
-> per-group split OBJs (tools/split_obj.py) with materials matched by the
reference's glob-over-group-name assignment rule.

Usage: python -m luisarender_tpu_torch.tools.disney2scene project_dir out_dir
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import math
import os
from pathlib import Path

import numpy as np

from .split_obj import split_obj


def _constant(v):
    if not isinstance(v, (list, tuple)):
        v = [float(v)]
    return {"impl": "constant", "prop": {"v": [float(x) for x in v[:3]]}}


def _matrix_prop(m_col_major):
    """Disney stores column-major 4x4 lists; our `matrix` transform takes
    row-major."""
    m = np.asarray(m_col_major, np.float64).reshape(4, 4).T
    return {"impl": "matrix", "prop": {"m": [float(x) for x in m.reshape(-1)]}}


def convert_camera(cam):
    eye = np.asarray(cam["eye"], np.float64)
    look = np.asarray(cam["look"], np.float64)
    up = np.asarray(cam["up"], np.float64)
    front = look - eye
    front = front / max(np.linalg.norm(front), 1e-12)
    ratio = float(cam.get("ratio", 16 / 9))
    width = int(cam.get("width", 1000))
    height = max(int(round(width / ratio)), 1)
    hfov = float(cam["fov"])
    vfov = (
        2.0 * math.atan(math.tan(math.radians(hfov) * 0.5) / ratio)
    ) * 180.0 / math.pi
    return {
        "impl": "pinhole",
        "prop": {
            "fov": vfov,
            "spp": int(cam.get("spp", 64)),
            "file": f"{cam.get('name', 'camera')}.exr",
            "film": {"impl": "color", "prop": {"resolution": [width, height]}},
            "filter": {"impl": "gaussian", "prop": {"radius": 1.0}},
            "transform": {
                "impl": "view",
                "prop": {
                    "origin": [float(x) for x in eye],
                    "front": [float(x) for x in front],
                    "up": [float(x) for x in up],
                },
            },
        },
    }


# unit quad in XY, centered at the origin (the reference ships quad.obj with
# this shape and instances it under each quad light's transform)
_QUAD = {
    "positions": [-0.5, -0.5, 0.0, 0.5, -0.5, 0.0, 0.5, 0.5, 0.0, -0.5, 0.5, 0.0],
    "indices": [0, 1, 2, 0, 2, 3],
}


def convert_light(name, light):
    color = np.asarray(light.get("color", [1, 1, 1]), np.float64)[:3]
    emission = color * float(2.0 ** light.get("exposure", 0.0))
    kind = light.get("type", "quad")
    if kind == "dome":
        return None, {
            "impl": "spherical",
            "prop": {"emission": _constant(list(emission))},
        }
    if kind != "quad":
        return None, None  # unsupported light types are skipped with a note
    m = np.asarray(light["translationMatrix"], np.float64).reshape(4, 4).T
    scale = np.diag(
        [float(light.get("width", 1.0)), float(light.get("height", 1.0)), 1.0, 1.0]
    )
    m = m @ scale
    shape = {
        "impl": "inlinemesh",
        "prop": {
            **_QUAD,
            "surface": {"impl": "null", "prop": {}},
            "light": {
                "impl": "diffuse",
                "prop": {
                    "emission": _constant([1.0, 1.0, 1.0]),
                    "scale": float(max(emission.max(), 0.0)),
                    "two_sided": True,
                },
            },
            "transform": {
                "impl": "matrix",
                "prop": {"m": [float(x) for x in m.reshape(-1)]},
            },
        },
    }
    # keep chroma: emission texture carries the normalized color
    mx = max(float(emission.max()), 1e-12)
    shape["prop"]["light"]["prop"]["emission"] = _constant(
        [float(c) / mx for c in emission]
    )
    return shape, None


def convert_material(mat):
    if mat is None:
        return {"impl": "null", "prop": {}}
    thin = mat.get("type") == "thin"
    prop = {
        "thin": thin,
        "color": _constant(mat.get("baseColor", [0.5, 0.5, 0.5])),
        "metallic": _constant(mat.get("metallic", 0.0)),
        "eta": _constant(mat.get("ior", 1.5)),
        "roughness": _constant(mat.get("roughness", 0.5)),
        "specular_tint": _constant(mat.get("specularTint", 0.0)),
        "anisotropic": _constant(mat.get("anisotropic", 0.0)),
        "sheen": _constant(mat.get("sheen", 0.0)),
        "sheen_tint": _constant(mat.get("sheenTint", 0.0)),
        "clearcoat": _constant(mat.get("clearcoat", 0.0)),
        "clearcoat_gloss": _constant(mat.get("clearcoatGloss", 1.0)),
        "specular_trans": _constant(mat.get("specTrans", 0.0)),
    }
    if thin:
        prop["flatness"] = _constant(mat.get("flatness", 0.0))
        prop["diffuse_trans"] = _constant(mat.get("diffTrans", 0.0))
    return {"impl": "disney", "prop": prop}


def _match_material(group_name, materials):
    """Reference assignment rule: each material lists glob patterns over OBJ
    group names; 'hidden' materials become null surfaces."""
    # split_obj names groups '<idx>.<tag>'; match on the tag
    tag = group_name.split(".", 1)[-1]
    for mname, mat in materials.items():
        for pattern in mat.get("assignment", []):
            if fnmatch.fnmatchcase(tag, pattern):
                if mname == "hidden":
                    return {"impl": "null", "prop": {}}
                return convert_material(mat)
    return convert_material(None) if "default" not in materials else (
        convert_material(materials["default"])
    )


def convert_element(project, element_dir, out_geo_dir):
    """One json/<element>/ directory -> list of shape dicts."""
    with open(element_dir / f"{element_dir.name}.json") as f:
        elem = json.load(f)
    with open(project / elem["matFile"]) as f:
        materials = json.load(f)
    obj_path = project / elem["geomObjFile"]
    parts = split_obj(obj_path, out_geo_dir)

    def instance_shapes(transform_col_major):
        shapes = []
        for gname, gpath in parts.items():
            surface = _match_material(gname, materials)
            prop = {
                "file": os.path.relpath(gpath, out_geo_dir.parent),
                "surface": surface,
            }
            if transform_col_major is not None:
                prop["transform"] = _matrix_prop(transform_col_major)
            shapes.append({"impl": "mesh", "prop": prop})
        return shapes

    shapes = instance_shapes(elem.get("transformMatrix"))
    for copy in elem.get("instancedCopies", {}).values():
        shapes += instance_shapes(copy["transformMatrix"])
    return shapes


def convert_project(project_dir, out_dir):
    project = Path(project_dir)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    geo_out = out / "geometry"
    geo_out.mkdir(exist_ok=True)

    cameras = []
    cam_dir = project / "json" / "cameras"
    if cam_dir.is_dir():
        for f in sorted(cam_dir.glob("*.json")):
            cameras.append(convert_camera(json.load(open(f))))

    shapes = []
    environment = None
    lights_file = project / "json" / "lights" / "lights.json"
    if lights_file.exists():
        for name, light in json.load(open(lights_file)).items():
            shape, env = convert_light(name, light)
            if shape is not None:
                shapes.append(shape)
            if env is not None:
                environment = env

    for element_dir in sorted((project / "json").iterdir()):
        if not element_dir.is_dir() or element_dir.name in ("cameras", "lights"):
            continue
        if not (element_dir / f"{element_dir.name}.json").exists():
            continue
        shapes += convert_element(project, element_dir, geo_out)

    render = {
        "cameras": cameras,
        "integrator": {"impl": "megapath", "prop": {"depth": 8}},
        "shapes": shapes,
    }
    if environment is not None:
        render["environment"] = environment
    scene = {"render": render}
    out_path = out / "scene.json"
    json.dump(scene, open(out_path, "w"), indent=1)
    return str(out_path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("project", help="Disney project directory (contains json/)")
    ap.add_argument("out", help="output directory")
    args = ap.parse_args(argv)
    print(convert_project(args.project, args.out))


if __name__ == "__main__":
    main()
