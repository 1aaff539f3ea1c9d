"""Convert GLSL-PathTracer `.scene` files to our JSON scene format.

The port's copy of luisarender_tpu/tools/glslpt2scene.py, a counterpart of
LuisaRender's tools/glslpt2luisa.py: same block-structured
text parsing (renderer/material/light/mesh/camera groups) and the same node
mapping — Disney surfaces with per-property constant/image textures,
metallic-roughness swizzles, quad/sphere area lights, thin-lens or pinhole
cameras (hfov -> vfov, focal length from fov), spherical environment with a
-90 deg yaw, instanced meshes, resolution upscaling to 1920-class. Pure
numpy/math (no glm), argparse CLI.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib


def _floats(v):
    return [float(x) for x in v]


def _quat_to_axis_angle(q):
    """GLSL-PathTracer rotations are quaternions given as (x, y, z, w) to
    glm.quat's list ctor — which reads (w, x, y, z); mirror that exactly."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    angle = math.degrees(2.0 * math.acos(max(-1.0, min(1.0, w))))
    n = math.sqrt(x * x + y * y + z * z)
    if n < 1e-12:
        return [0.0, 1.0, 0.0, 0.0]
    return [x / n, y / n, z / n, angle]


def _normalize(v):
    n = math.sqrt(sum(x * x for x in v))
    return [x / n for x in v]


_DISNEY_CONST = {
    # glslpt key -> (our Disney prop, transform)
    "color": ("color", _floats),
    "opacity": ("alpha", lambda v: float(v[0])),
    "metallic": ("metallic", lambda v: float(v[0])),
    "roughness": ("roughness", lambda v: math.sqrt(float(v[0]))),
    "subsurface": ("subsurface", lambda v: float(v[0])),
    "speculartint": ("specular_tint", lambda v: float(v[0])),
    "anisotropic": ("anisotropic", lambda v: float(v[0])),
    "sheen": ("sheen", lambda v: float(v[0])),
    "sheentint": ("sheen_tint", lambda v: float(v[0])),
    "clearcoat": ("clearcoat", lambda v: float(v[0])),
    "clearcoatgloss": ("clearcoat_gloss", lambda v: float(v[0])),
    "spectrans": ("specular_trans", lambda v: float(v[0])),
    "ior": ("eta", lambda v: float(v[0])),
}


def parse_blocks(path):
    """-> [(tag, {key: [tokens]})] for renderer/material/light/mesh/camera."""
    nodes = []
    curr = None
    with open(path) as f:
        for raw in f:
            line = raw.strip().split()
            if not line or line[0].startswith("#"):
                continue
            if curr is None and line[0] in (
                "renderer", "material", "light", "mesh", "camera", "gltf"
            ):
                curr = (line[0], {})
                if line[0] == "material":
                    curr[1]["name"] = [line[1]]
            elif line[0] == "}":
                if curr is not None:
                    nodes.append(curr)
                curr = None
            elif line[0] != "{" and curr is not None:
                curr[1][line[0]] = line[1:]
    return nodes


def do_conversion(scene_name, nodes):
    textures, surfaces, meshes, emissive = {}, {}, {}, {}
    render = {
        "integrator": {
            "impl": "wavepath",
            "prop": {"sampler": {"impl": "pmj02bn"}},
        },
        "cameras": [],
        "shapes": [],
    }
    spp = 1024
    resolution = [1920, 1080]
    env_scale = 1.0
    hide_emissive = False

    def get_texture(file, linear=True):
        if file.endswith(".exr") or file.endswith(".hdr"):
            linear = True
        if file not in textures:
            textures[file] = {
                "type": "Texture",
                "impl": "image",
                "prop": {
                    "file": file,
                    "encoding": "linear" if linear else "srgb",
                },
            }
        return f"@Texture:{file}"

    for tag, prop in nodes:
        if tag == "renderer":
            for k, v in prop.items():
                if k == "envmapfile" and v[0] != "none":
                    render["environment"] = {
                        "impl": "spherical",
                        "prop": {
                            "emission": {
                                "impl": "image",
                                "prop": {"file": v[0]},
                            },
                            "transform": {
                                "impl": "srt",
                                "prop": {"rotate": [0, 1, 0, -90]},
                            },
                        },
                    }
                elif k == "resolution":
                    resolution = [int(v[0]), int(v[1])]
                elif k == "envmapintensity":
                    env_scale = float(v[0])
                elif k == "hideemitters":
                    hide_emissive = v[0] == "true"
        elif tag == "mesh":
            file = prop["file"][0]
            material = prop["material"][0]
            if file not in meshes:
                meshes[file] = {
                    "type": "Shape",
                    "impl": "mesh",
                    "prop": {"file": file, "shadow_terminator": 1.0},
                }
            shape = {
                "impl": "instance",
                "prop": {
                    "shape": f"@Mesh:{file}",
                    "surface": f"@Surface:{material}",
                    "shadow_terminator": 1.0,
                },
            }
            if material in emissive:
                shape["prop"]["light"] = f"@Light:{material}"
            if "matrix" in prop:
                shape["prop"]["transform"] = {
                    "impl": "matrix",
                    "prop": {"m": _floats(prop["matrix"])},
                }
            elif any(k in prop for k in ("position", "rotation", "scale")):
                shape["prop"]["transform"] = {
                    "impl": "srt",
                    "prop": {
                        "translate": _floats(prop.get("position", [0, 0, 0])),
                        "rotate": _quat_to_axis_angle(
                            _floats(prop["rotation"])
                        ) if "rotation" in prop else [0, 1, 0, 0],
                        "scale": _floats(prop.get("scale", [1, 1, 1])),
                    },
                }
            render["shapes"].append(shape)
        elif tag == "material":
            name = prop["name"][0]
            sprop = {}
            for k, v in prop.items():
                if k in _DISNEY_CONST:
                    key, f = _DISNEY_CONST[k]
                    if key not in sprop:
                        sprop[key] = {
                            "impl": "constant", "prop": {"v": f(v)}
                        }
                elif k == "albedotexture":
                    sprop["color"] = get_texture(v[0], False)
                elif k == "metallicroughnesstexture":
                    t = get_texture(v[0])
                    sprop["metallic"] = {
                        "impl": "swizzle", "prop": {"base": t, "swizzle": 2}
                    }
                    sprop["roughness"] = {
                        "impl": "swizzle", "prop": {"base": t, "swizzle": 1}
                    }
                elif k == "normaltexture":
                    sprop["normal_map"] = get_texture(v[0])
                elif k == "emission":
                    emissive.setdefault(name, {
                        "type": "Light",
                        "impl": "diffuse",
                        "prop": {
                            "emission": {
                                "impl": "constant",
                                "prop": {"v": _floats(v)},
                            }
                        },
                    })
                elif k == "emissiontexture":
                    emissive[name] = {
                        "type": "Light",
                        "impl": "diffuse",
                        "prop": {"emission": get_texture(v[0], False)},
                    }
                elif k != "name":
                    print(f"unrecognized material property: {k}")
            sprop.setdefault(
                "roughness", {"impl": "constant", "prop": {"v": 1}}
            )
            surfaces[name] = {
                "type": "Surface", "impl": "disney", "prop": sprop
            }
        elif tag == "light":
            kind = prop["type"][0]
            emission = {
                "impl": "diffuse",
                "prop": {
                    "emission": {
                        "impl": "constant",
                        "prop": {"v": _floats(prop["emission"])},
                    }
                },
            }
            if kind == "quad":
                p0 = _floats(prop["position"])
                p1 = _floats(prop["v1"])
                p3 = _floats(prop["v2"])
                p2 = [p3[i] + p1[i] - p0[i] for i in range(3)]
                render["shapes"].append({
                    "impl": "inlinemesh",
                    "prop": {
                        "indices": [0, 1, 2, 0, 2, 3],
                        "positions": p0 + p1 + p2 + p3,
                        "light": emission,
                    },
                })
            elif kind == "sphere":
                meshes["glslpt-sphere"] = {
                    "type": "Shape",
                    "impl": "sphere",
                    "prop": {"subdivision": 4},
                }
                render["shapes"].append({
                    "impl": "instance",
                    "prop": {
                        "shape": "@Mesh:glslpt-sphere",
                        "transform": {
                            "impl": "srt",
                            "prop": {
                                "scale": float(prop["radius"][0]),
                                "translate": _floats(prop["position"]),
                            },
                        },
                        "light": emission,
                    },
                })
            else:
                raise NotImplementedError(f"light type {kind}")
        elif tag == "camera":
            fov_h = float(prop["fov"][0])
            lens_diameter = float(prop.get("aperture", [0.001])[0])
            focal_length = 18.0 / math.tan(math.radians(fov_h) / 2)
            fov = math.degrees(2 * math.atan(
                math.tan(math.radians(fov_h) / 2)
                * resolution[1] / resolution[0]
            ))
            aperture = focal_length / 100000 / lens_diameter
            if "matrix" in prop:
                m = _floats(prop["matrix"])  # column-major
                mt = [[m[j * 4 + i] for j in range(4)] for i in range(4)]
                position = mt[3][:3]
                front = mt[2][:3]
            else:
                position = _floats(prop["position"])
                target = _floats(prop["lookat"])
                front = _normalize(
                    [target[i] - position[i] for i in range(3)]
                )
            if "focaldist" in prop:
                camera = {
                    "impl": "thinlens",
                    "prop": {
                        "focal_length": focal_length,
                        "focus_distance": float(prop["focaldist"][0]),
                        "aperture": aperture,
                    },
                }
            else:
                camera = {"impl": "pinhole", "prop": {"fov": fov}}
            camera["prop"]["transform"] = {
                "impl": "view",
                "prop": {"origin": position, "front": front},
            }
            render["cameras"].append(camera)
        elif tag == "gltf":
            raise NotImplementedError(
                "gltf blocks: convert with tools/gltf2scene.py first"
            )

    if hide_emissive:
        for s in render["shapes"]:
            if "light" in s["prop"]:
                s["prop"]["visible"] = False
    if "environment" in render:
        render["environment"]["prop"]["scale"] = env_scale
    if (r := max(*resolution)) < 1920:
        resolution = [int(round(x * 1920 / r)) for x in resolution]
    for i, camera in enumerate(cc := render["cameras"]):
        camera["prop"]["film"] = {
            "impl": "color",
            "prop": {"resolution": resolution, "clamp": 64},
        }
        camera["prop"]["file"] = (
            f"{scene_name}-view-{i}.exr" if len(cc) > 1 else f"{scene_name}.exr"
        )
        camera["prop"]["filter"] = {
            "impl": "gaussian",
            "prop": {
                "radius": max(
                    1, min(3, 0.5 * round(min(*resolution) / 1024 * 3))
                )
            },
        }
        camera["prop"]["spp"] = spp

    scene = {"render": render}
    for group, prefix in (
        (meshes, "Mesh"), (surfaces, "Surface"),
        (textures, "Texture"), (emissive, "Light"),
    ):
        for name, node in group.items():
            scene[f"{prefix}:{name}"] = node
    return scene


def convert(path, out_path=None):
    nodes = parse_blocks(path)
    scene = do_conversion(pathlib.Path(path).stem, nodes)
    if out_path is None:
        out_path = (
            path[: -len(".scene")] if path.endswith(".scene") else path
        ) + ".json"
    with open(out_path, "w") as f:
        json.dump(scene, f, indent=2)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scene", help="GLSL-PathTracer .scene file")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)
    print(f"wrote {convert(args.scene, args.output)}")


if __name__ == "__main__":
    main()
