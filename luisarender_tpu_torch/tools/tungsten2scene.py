"""Tungsten scene (Benedikt Bitterli's renderer / rendering-resources
repository) -> luisarender_tpu_torch JSON scene converter.

The port's copy of luisarender_tpu/tools/tungsten2scene.py, a counterpart
of LuisaRender's tools/tungsten2luisa.py (which emits its text
SDL and requires .wo3 meshes to be pre-converted to OBJ); this one targets
our JSON schema directly and reads Tungsten's binary .wo3 mesh format
natively (layout: u64 vertex count, vertices as interleaved
pos.xyz/normal.xyz/uv.xy float32, u64 triangle count, triangles as four
int32s v0,v1,v2,material).

Tungsten schema essentials handled here:
- `bsdfs`: named materials — lambert / oren_nayar / plastic / rough_plastic /
  dielectric / rough_dielectric / mirror / conductor / rough_conductor /
  thinsheet / null. Albedos are scalars, [r,g,b], bitmap path strings, or
  {"type": "checker", ...}.
- `primitives`: mesh (.wo3) / quad / cube / disk / sphere with SRT transforms
  (Euler rotation applied in YXZ order, Tungsten's convention);
  `infinite_sphere` -> spherical environment (rotated -90 deg about Y, the
  lat-long phase Tungsten uses); `infinite_sphere_cap` -> directional light;
  emissive primitives -> area lights.
- `camera`: position/look_at/up, horizontal fov (degrees), resolution;
  `renderer.spp`, `integrator.max_bounces`.

Usage:
    python -m luisarender_tpu_torch.tools.tungsten2scene scene.json out_scene.json
"""

from __future__ import annotations

import argparse
import json
import math
import struct
from pathlib import Path

import numpy as np

_METAL_NAMES = {"Cu", "Au", "Ag", "Al", "Fe", "Ti", "Cr", "Ni", "W"}


def read_wo3(path: Path):
    """Returns (positions (V,3) f32, indices (T,3) i32)."""
    data = path.read_bytes()
    (nv,) = struct.unpack_from("<Q", data, 0)
    off = 8
    verts = np.frombuffer(data, np.float32, count=nv * 8, offset=off)
    verts = verts.reshape(nv, 8)
    off += nv * 32
    (nt,) = struct.unpack_from("<Q", data, off)
    off += 8
    tris = np.frombuffer(data, np.int32, count=nt * 4, offset=off)
    tris = tris.reshape(nt, 4)[:, :3]
    return np.ascontiguousarray(verts[:, 0:3]), np.ascontiguousarray(tris)


def wo3_to_obj(src: Path, dst: Path):
    data = src.read_bytes()
    (nv,) = struct.unpack_from("<Q", data, 0)
    verts = np.frombuffer(data, np.float32, count=nv * 8, offset=8).reshape(nv, 8)
    off = 8 + nv * 32
    (nt,) = struct.unpack_from("<Q", data, off)
    tris = np.frombuffer(data, np.int32, count=nt * 4, offset=off + 8).reshape(nt, 4)
    with open(dst, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for v in verts:
            f.write(f"vn {v[3]} {v[4]} {v[5]}\n")
        for v in verts:
            f.write(f"vt {v[6]} {v[7]}\n")
        for t in tris:
            a, b, c = t[0] + 1, t[1] + 1, t[2] + 1
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------


def convert_texture(value, default=(1.0, 1.0, 1.0)):
    if value is None:
        value = list(default)
    if isinstance(value, (int, float)):
        return {"impl": "constant", "prop": {"v": [float(value)] * 3}}
    if isinstance(value, (list, tuple)):
        return {"impl": "constant", "prop": {"v": [float(x) for x in value]}}
    if isinstance(value, str):
        return {"impl": "image", "prop": {"file": value}}
    if isinstance(value, dict):
        t = value.get("type")
        if t == "checker":
            return {
                "impl": "checkerboard",
                "prop": {
                    "on": convert_texture(value.get("on_color", 0.8)),
                    "off": convert_texture(value.get("off_color", 0.2)),
                    "scale": [
                        float(value.get("res_u", 20)) / 2.0,
                        float(value.get("res_v", 20)) / 2.0,
                    ],
                },
            }
        if t == "constant":
            return convert_texture(value.get("value", list(default)))
        if t == "bitmap":
            return {"impl": "image", "prop": {"file": value.get("file", "")}}
    raise ValueError(f"unsupported Tungsten texture: {value!r}")


# ---------------------------------------------------------------------------
# materials
# ---------------------------------------------------------------------------


def _roughness_tex(material):
    r = float(material.get("roughness", 0.1))
    # Tungsten roughness is GGX alpha-like; ours remaps from artist roughness
    return {"impl": "constant", "prop": {"v": [math.sqrt(max(r, 0.0))]}}


def convert_material(material: dict):
    impl = material["type"]
    albedo = material.get("albedo", 0.8)
    if impl in ("lambert", "oren_nayar"):
        prop = {"Kd": convert_texture(albedo)}
        if impl == "oren_nayar":
            sigma_deg = math.degrees(float(material.get("sigma", 0.0)))
            prop["sigma"] = {"impl": "constant", "prop": {"v": [sigma_deg]}}
        return {"impl": "matte", "prop": prop}
    if impl in ("plastic", "rough_plastic"):
        prop = {
            "Kd": convert_texture(albedo),
            "eta": {
                "impl": "constant",
                "prop": {"v": [float(material.get("ior", 1.5))]},
            },
        }
        if impl == "rough_plastic":
            prop["roughness"] = _roughness_tex(material)
        return {"impl": "plastic", "prop": prop}
    if impl in ("dielectric", "rough_dielectric", "thinsheet"):
        prop = {
            "Kr": convert_texture(albedo),
            "Kt": convert_texture(albedo),
            "eta": {
                "impl": "constant",
                "prop": {"v": [float(material.get("ior", 1.5))]},
            },
        }
        if impl == "rough_dielectric":
            prop["roughness"] = _roughness_tex(material)
        if impl == "thinsheet":
            print("warning: thinsheet approximated as smooth dielectric")
        return {"impl": "glass", "prop": prop}
    if impl == "mirror":
        return {"impl": "mirror", "prop": {"Kd": convert_texture(albedo)}}
    if impl in ("conductor", "rough_conductor"):
        name = material.get("material", "Cu")
        prop = {"Kd": convert_texture(albedo)}
        if name in _METAL_NAMES:
            prop["eta"] = name
        if impl == "rough_conductor":
            prop["roughness"] = _roughness_tex(material)
        return {"impl": "metal", "prop": prop}
    if impl == "null":
        return {"impl": "null", "prop": {}}
    # transparency/forward/etc: approximate as matte and warn
    print(f"warning: material type '{impl}' approximated as matte")
    return {"impl": "matte", "prop": {"Kd": convert_texture(albedo)}}


# ---------------------------------------------------------------------------
# transforms (Tungsten: scale, then Euler rotation in YXZ order, then move)
# ---------------------------------------------------------------------------


def _vec3(v, default):
    if v is None:
        return [default] * 3
    if isinstance(v, (int, float)):
        return [float(v)] * 3
    return [float(x) for x in v]


def _rot(axis, deg):
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def transform_matrix(transform: dict) -> np.ndarray:
    t = _vec3(transform.get("position"), 0.0)
    r = _vec3(transform.get("rotation"), 0.0)
    s = _vec3(transform.get("scale"), 1.0)
    rot = _rot(1, r[1]) @ _rot(0, r[0]) @ _rot(2, r[2])  # YXZ
    m = np.eye(4)
    m[:3, :3] = rot @ np.diag(s)
    m[:3, 3] = t
    return m


def matrix_node(m: np.ndarray) -> dict:
    return {"impl": "matrix", "prop": {"m": [float(x) for x in m.reshape(-1)]}}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

_QUAD = {  # Tungsten's quad: unit square in the XZ plane, +Y normal
    "positions": [-0.5, 0, -0.5, 0.5, 0, -0.5, 0.5, 0, 0.5, -0.5, 0, 0.5],
    "indices": [0, 1, 2, 0, 2, 3],
}
_CUBE_P = [
    -0.5, -0.5, -0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5, -0.5,
    -0.5, -0.5, 0.5, 0.5, -0.5, 0.5, 0.5, 0.5, 0.5, -0.5, 0.5, 0.5,
]
_CUBE_I = [
    0, 2, 1, 0, 3, 2, 4, 5, 6, 4, 6, 7, 0, 1, 5, 0, 5, 4,
    3, 6, 2, 3, 7, 6, 1, 2, 6, 1, 6, 5, 0, 4, 7, 0, 7, 3,
]


def _disk_mesh(n=32):
    pos, idx = [0.0, 0.0, 0.0], []
    for i in range(n):
        a = 2 * math.pi * i / n
        pos += [0.5 * math.cos(a), 0.0, 0.5 * math.sin(a)]
    for i in range(n):
        idx += [0, 1 + (i + 1) % n, 1 + i]
    return {"positions": pos, "indices": idx}


def convert_primitive(index, prim, materials, asset_dir, scene_dir, out):
    impl = prim["type"]
    if impl == "infinite_sphere":
        rot = {"impl": "srt", "prop": {"rotate": [0.0, 1.0, 0.0, -90.0]}}
        out["environment"] = {
            "impl": "spherical",
            "prop": {
                "emission": convert_texture(prim.get("emission", 1.0)),
                "transform": rot,
            },
        }
        return
    if impl == "infinite_sphere_cap":
        power = float(prim.get("power", 100.0))
        emission = power / (100.0 * math.pi)
        out["environment"] = {
            "impl": "directional",
            "prop": {
                "emission": {
                    "impl": "constant", "prop": {"v": [emission] * 3}
                },
                "angle": float(prim.get("cap_angle", 5.0)),
                "transform": matrix_node(transform_matrix(prim.get("transform", {}))),
                "scale": 4.0 * math.pi,
            },
        }
        return

    m = transform_matrix(prim.get("transform", {}))
    bsdf = prim.get("bsdf", "")
    if isinstance(bsdf, str):
        surface = f"@{bsdf}" if bsdf else {"impl": "null", "prop": {}}
    else:
        surface = convert_material(bsdf)

    if impl == "mesh":
        src = Path(scene_dir) / prim["file"]
        if src.suffix == ".wo3":
            dst = Path(asset_dir) / (src.stem + ".obj")
            dst.parent.mkdir(parents=True, exist_ok=True)
            wo3_to_obj(src, dst)
            shape = {"impl": "mesh", "prop": {"file": str(dst)}}
        else:
            shape = {"impl": "mesh", "prop": {"file": str(src)}}
    elif impl == "quad":
        shape = {"impl": "inlinemesh", "prop": dict(_QUAD)}
    elif impl == "cube":
        shape = {
            "impl": "inlinemesh",
            "prop": {"positions": list(_CUBE_P), "indices": list(_CUBE_I)},
        }
    elif impl == "disk":
        shape = {"impl": "inlinemesh", "prop": _disk_mesh()}
    elif impl == "sphere":
        shape = {"impl": "sphere", "prop": {"subdivision": 4}}
        m = m @ np.diag([0.5, 0.5, 0.5, 1.0])  # unit-diameter convention
    else:
        print(f"warning: unsupported primitive '{impl}' skipped")
        return

    shape["prop"]["surface"] = surface
    shape["prop"]["transform"] = matrix_node(m)
    emission = prim.get("emission")
    if emission is not None:
        shape["prop"]["light"] = {
            "impl": "diffuse",
            "prop": {"emission": convert_texture(emission)},
        }
    power = prim.get("power")
    if power is not None and emission is None:
        # radiant power (W) over the primitive's area: approximate with the
        # transformed quad area like the reference does (tools/tungsten2luisa)
        s = _vec3(prim.get("transform", {}).get("scale"), 1.0)
        area = max(s[0] * s[2], 1e-6)
        val = float(power) / (100.0 * math.pi * area)
        shape["prop"]["light"] = {
            "impl": "diffuse",
            "prop": {"emission": {"impl": "constant", "prop": {"v": [val] * 3}}},
        }
    out["shapes"].append(shape)


def convert_camera(camera: dict, spp: int) -> dict:
    tr = camera.get("transform", {})
    res = camera.get("resolution", [1024, 1024])
    if isinstance(res, (int, float)):
        res = [res, res]
    fov_x = float(camera.get("fov", 60.0))
    w, h = float(res[0]), float(res[1])
    # Tungsten fov is horizontal; ours is vertical
    fov_y = math.degrees(
        2.0 * math.atan(math.tan(math.radians(fov_x) / 2.0) * h / w)
    )
    pos = _vec3(tr.get("position"), 0.0)
    look = _vec3(tr.get("look_at"), 0.0)
    up = _vec3(tr.get("up"), 0.0)
    if up == [0.0, 0.0, 0.0]:
        up = [0.0, 1.0, 0.0]
    front = [look[i] - pos[i] for i in range(3)]
    return {
        "impl": "pinhole",
        "prop": {
            "fov": fov_y,
            "spp": spp,
            "film": {
                "impl": "color",
                "prop": {"resolution": [int(res[0]), int(res[1])]},
            },
            "filter": {"impl": "gaussian", "prop": {"radius": 1.0}},
            "transform": {
                "impl": "view",
                "prop": {"origin": pos, "front": front, "up": up},
            },
        },
    }


def convert(scene_path: str, out_path: str, asset_dir: str | None = None):
    scene_path = Path(scene_path)
    scene = json.loads(scene_path.read_text())
    out_dir = Path(out_path).parent
    assets = Path(asset_dir) if asset_dir else out_dir / "assets"

    spp = int(scene.get("renderer", {}).get("spp", 64))
    depth = int(scene.get("integrator", {}).get("max_bounces", 8)) + 1

    render: dict = {"shapes": [], "integrator": {"impl": "megapath", "prop": {"depth": depth}}}
    doc = {"render": render}
    for name, mat in _named_materials(scene).items():
        doc[name] = {"type": "Surface", **convert_material(mat)}
    render["cameras"] = [convert_camera(scene.get("camera", {}), spp)]
    for i, prim in enumerate(scene.get("primitives", [])):
        convert_primitive(i, prim, scene.get("bsdfs", []), assets,
                          scene_path.parent, render)
    Path(out_path).write_text(json.dumps(doc, indent=1))
    print(f"wrote {out_path}: {len(render['shapes'])} shapes, spp {spp}")
    return doc


def _named_materials(scene) -> dict:
    mats = {}
    for mat in scene.get("bsdfs", []):
        name = mat.get("name")
        if name:
            mats[name] = mat
    return mats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="Tungsten scene.json")
    ap.add_argument("output", help="output luisarender_tpu_torch scene JSON")
    ap.add_argument("--assets", default=None,
                    help="directory for converted .wo3 -> .obj meshes")
    args = ap.parse_args(argv)
    convert(args.input, args.output, args.assets)


if __name__ == "__main__":
    main()
