"""Convert a LuxCoreRender flattened `.scn` scene into our JSON scene format.

The port's copy of luisarender_tpu/tools/lux2scene.py, a counterpart of
LuisaRender's tools/lux2luisa.py (same `.scn` dotted
key=value parsing and the same node mapping: lookat camera -> pinhole/view,
imagemap/constfloat textures, matte/roughmatte/glass materials, emissive
materials -> diffuse lights with scale 100, PLY objects with optional 4x4
transforms). Emits the JSON SDL (scene/parser.py) instead of the `.luisa`
text SDL — both front-ends load the same node graph here.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def parse_scn(path: str) -> dict:
    """Flattened `scene.a.b.c = value` lines -> nested dict."""
    result: dict = {}
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw or raw.startswith("#") or "=" not in raw:
                continue
            key, value = raw.split("=", 1)
            segs = key.strip().split(".")
            value = value.strip()
            if value.startswith('"'):
                parsed = value.strip('"')
            else:
                vals = value.split()
                if len(vals) == 1:
                    fv = float(vals[0])
                    parsed = int(fv) if fv == int(fv) else fv
                else:
                    parsed = [float(v) for v in vals]
            node = result
            for seg in segs[:-1]:
                node = node.setdefault(seg, {})
            node[segs[-1]] = parsed
    if set(result) != {"scene"}:
        raise ValueError("expected a single top-level 'scene' namespace")
    return result["scene"]


def _norm(v):
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v)).tolist()


def convert_camera(scene: dict) -> dict:
    cam = scene["camera"]
    position = np.asarray(cam["lookat"]["orig"], np.float64)
    target = np.asarray(cam["lookat"]["target"], np.float64)
    return {
        "impl": "pinhole",
        "prop": {
            "fov": cam["fieldofview"],
            "spp": 1024,
            "filter": {"impl": "gaussian", "prop": {"radius": 1}},
            "film": {"impl": "color", "prop": {}},
            "transform": {
                "impl": "view",
                "prop": {
                    "origin": position.tolist(),
                    "front": _norm(target - position),
                    "up": _norm(cam["up"]),
                },
            },
        },
    }


def convert_texture(name: str, desc: dict) -> dict:
    t = desc["type"]
    if t == "imagemap":
        us = desc["mapping"]["uvscale"]
        uo = desc["mapping"]["uvdelta"]
        return {
            "type": "Texture",
            "impl": "image",
            "prop": {
                "file": desc["file"],
                "encoding": "gamma",
                "gamma": desc["gamma"],
                "scale": desc["gain"],
                "uv_scale": [us[0], -us[1]],
                "uv_offset": [uo[0], uo[1]],
            },
        }
    if t in ("constfloat1", "constfloat2", "constfloat3", "constfloat4"):
        v = desc["value"]
        return {
            "type": "Texture",
            "impl": "constant",
            "prop": {"v": v if isinstance(v, list) else [v]},
        }
    raise NotImplementedError(f"texture {name}: {t}")


def convert_surface(name: str, desc: dict) -> dict:
    t = desc["type"]
    prop: dict = {}
    if "transparency" in desc:
        prop["alpha"] = f"@{desc['transparency']}"
    if t == "matte":
        prop["Kd"] = f"@{desc['kd']}"
        return {"type": "Surface", "impl": "matte", "prop": prop}
    if t == "roughmatte":
        prop["Kd"] = f"@{desc['kd']}"
        prop["sigma"] = f"@{desc['sigma']}"
        return {"type": "Surface", "impl": "matte", "prop": prop}
    if t == "glass":
        prop["Kr"] = f"@{desc['kr']}"
        prop["Kt"] = f"@{desc['kt']}"
        prop["roughness"] = {"impl": "constant", "prop": {"v": [0.2]}}
        return {"type": "Surface", "impl": "glass", "prop": prop}
    raise NotImplementedError(f"surface {name}: {t}")


def convert(scn_path: str, out_path: str | None = None) -> str:
    scene = parse_scn(scn_path)
    lights = {
        name: desc
        for name, desc in scene.get("materials", {}).items()
        if isinstance(desc.get("emission"), str)
        or (isinstance(desc.get("emission"), dict) and desc["emission"].get("power", 0) != 0)
    }

    doc: dict = {}
    for name, desc in scene.get("textures", {}).items():
        doc[name] = convert_texture(name, desc)
    for name, desc in scene.get("materials", {}).items():
        doc[name] = convert_surface(name, desc)
    for name, desc in lights.items():
        if not isinstance(desc["emission"], str):
            raise NotImplementedError("numeric emission power")
        doc[f"{name}_EMISSION"] = {
            "type": "Light",
            "impl": "diffuse",
            "prop": {"emission": f"@{desc['emission']}", "scale": 100},
        }

    shape_names = []
    for name, desc in scene.get("objects", {}).items():
        prop: dict = {"file": desc["ply"], "surface": f"@{desc['material']}"}
        if "transformation" in desc:
            # LuxCore stores column-major; our Matrix takes row-major m
            t = np.reshape(desc["transformation"], (4, 4)).T
            prop["transform"] = {
                "impl": "matrix",
                "prop": {"m": [float(x) for x in t.reshape(-1)]},
            }
        if desc["material"] in lights:
            prop["light"] = f"@{desc['material']}_EMISSION"
        doc[name] = {"type": "Shape", "impl": "mesh", "prop": prop}
        shape_names.append(f"@{name}")

    doc["render"] = {
        "cameras": [convert_camera(scene)],
        "integrator": {
            "impl": "wavepath",
            "prop": {
                "spectrum": {"impl": "hero", "prop": {}},
                "depth": 12,
                "rr_depth": 4,
            },
        },
        "shapes": shape_names,
    }

    if out_path is None:
        out_path = scn_path[:-4] + ".json" if scn_path.endswith(".scn") else scn_path + ".json"
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scn", help="LuxCoreRender .scn file")
    ap.add_argument("-o", "--output", default=None, help="output .json path")
    args = ap.parse_args(argv)
    out = convert(args.scn, args.output)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
