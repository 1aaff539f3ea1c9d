"""Test scenes as JSON-SDL dicts: the Cornell box and the mesh-heavy scene,
and their forms under the hero spectrum.

Counterpart of luisarender_tpu/testing.py `cornell_box` and `mesh_heavy`.
Cornell geometry uses the classic Cornell box measurement data (public
domain, cornell.edu); reflectances and emission follow the common
PBRT/Bitterli RGB values.
"""

from __future__ import annotations

import numpy as np


def _quad(p0, p1, p2, p3):
    """Two triangles for a quad, wound p0-p1-p2 / p0-p2-p3."""
    return {
        "impl": "inlinemesh",
        "prop": {
            "positions": [c for p in (p0, p1, p2, p3) for c in p],
            "indices": [0, 1, 2, 0, 2, 3],
        },
    }


WHITE = [0.725, 0.71, 0.68]
RED = [0.63, 0.065, 0.05]
GREEN = [0.14, 0.45, 0.091]
LIGHT_EMISSION = [17.0, 12.0, 4.0]


def cornell_box(resolution=(64, 64), spp=16, depth=5, integrator=None, **int_props):
    """Scene dict for the Cornell box. resolution (w, h)."""
    integrator = integrator or "megapath"
    white = {"impl": "matte", "prop": {"Kd": {"impl": "constant", "prop": {"v": WHITE}}}}
    red = {"impl": "matte", "prop": {"Kd": {"impl": "constant", "prop": {"v": RED}}}}
    green = {"impl": "matte", "prop": {"Kd": {"impl": "constant", "prop": {"v": GREEN}}}}

    def shape(quad, surface, light=None):
        # attach surface/light on the mesh directly
        q = dict(quad)
        prop = dict(q["prop"])
        prop["surface"] = surface
        if light is not None:
            prop["light"] = light
        q["prop"] = prop
        return q

    shapes = [
        # floor
        shape(_quad([552.8, 0, 0], [0, 0, 0], [0, 0, 559.2], [549.6, 0, 559.2]), white),
        # ceiling
        shape(
            _quad([556, 548.8, 0], [556, 548.8, 559.2], [0, 548.8, 559.2], [0, 548.8, 0]),
            white,
        ),
        # back wall
        shape(
            _quad([549.6, 0, 559.2], [0, 0, 559.2], [0, 548.8, 559.2], [556, 548.8, 559.2]),
            white,
        ),
        # right wall (green)
        shape(_quad([0, 0, 559.2], [0, 0, 0], [0, 548.8, 0], [0, 548.8, 559.2]), green),
        # left wall (red)
        shape(
            _quad([552.8, 0, 0], [549.6, 0, 559.2], [556, 548.8, 559.2], [556, 548.8, 0]),
            red,
        ),
        # short block
        shape(
            {
                "impl": "inlinemesh",
                "prop": {
                    "positions": [
                        130.0, 165.0, 65.0, 82.0, 165.0, 225.0, 240.0, 165.0, 272.0,
                        290.0, 165.0, 114.0, 130.0, 0.0, 65.0, 82.0, 0.0, 225.0,
                        240.0, 0.0, 272.0, 290.0, 0.0, 114.0,
                    ],
                    "indices": [
                        0, 1, 2, 0, 2, 3,  # top
                        4, 0, 3, 4, 3, 7,  # front
                        5, 1, 0, 5, 0, 4,  # left
                        6, 2, 1, 6, 1, 5,  # back
                        7, 3, 2, 7, 2, 6,  # right
                    ],
                },
            },
            white,
        ),
        # tall block
        shape(
            {
                "impl": "inlinemesh",
                "prop": {
                    "positions": [
                        423.0, 330.0, 247.0, 265.0, 330.0, 296.0, 314.0, 330.0, 456.0,
                        472.0, 330.0, 406.0, 423.0, 0.0, 247.0, 265.0, 0.0, 296.0,
                        314.0, 0.0, 456.0, 472.0, 0.0, 406.0,
                    ],
                    "indices": [
                        0, 1, 2, 0, 2, 3,
                        4, 0, 3, 4, 3, 7,
                        5, 1, 0, 5, 0, 4,
                        6, 2, 1, 6, 1, 5,
                        7, 3, 2, 7, 2, 6,
                    ],
                },
            },
            white,
        ),
        # light (y slightly below ceiling, normal facing down)
        shape(
            _quad(
                [343.0, 548.0, 227.0],
                [343.0, 548.0, 332.0],
                [213.0, 548.0, 332.0],
                [213.0, 548.0, 227.0],
            ),
            white,
            light={
                "impl": "diffuse",
                "prop": {
                    "emission": {"impl": "constant", "prop": {"v": LIGHT_EMISSION}}
                },
            },
        ),
    ]

    return {
        "render": {
            "cameras": [
                {
                    "impl": "pinhole",
                    "prop": {
                        "fov": 39.3077,
                        "spp": spp,
                        "file": "cornell.exr",
                        "film": {
                            "impl": "color",
                            "prop": {"resolution": list(resolution)},
                        },
                        "filter": {"impl": "box", "prop": {}},
                        "transform": {
                            "impl": "view",
                            "prop": {
                                "origin": [278.0, 273.0, -800.0],
                                "front": [0.0, 0.0, 1.0],
                                "up": [0.0, 1.0, 0.0],
                            },
                        },
                    },
                }
            ],
            "integrator": {
                "impl": integrator,
                "prop": {"depth": depth, **int_props},
            },
            "shapes": shapes,
        }
    }


def cornell_sphere(resolution=(48, 48), spp=8, depth=5):
    """The Cornell box plus a matte icosphere mesh of subdivision 3 floating
    just above the short block: 32 + 1,280 = 1,312 triangles, so it traces
    with the cluster kernel. Its 48^2, 8-spp, depth-5 render by the
    reference is tests/golden/cornell_sphere_48_8spp.exr."""
    d = cornell_box(resolution=resolution, spp=spp, depth=depth)
    d["render"]["shapes"].append({"impl": "sphere", "prop": {
        "analytic": False, "subdivision": 3,
        "surface": {"impl": "matte", "prop": {
            "Kd": {"impl": "constant", "prop": {"v": [0.5, 0.5, 0.5]}}}},
        "transform": {"impl": "srt", "prop": {"scale": [80, 80, 80],
                                              "translate": [186, 250, 168]}}}})
    return d


def _build_file(stem, suffix, content: bytes, write) -> str:
    """A generated input file under the package's build directory, named
    by a hash of its content and written once (write(path)) through a
    temporary name; returns its path."""
    import hashlib
    import os
    from pathlib import Path

    name = f"{stem}-{hashlib.sha1(content).hexdigest()[:12]}{suffix}"
    out = Path(__file__).resolve().parent / "_build" / name
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{name}.{os.getpid()}.tmp{suffix}")
        write(tmp)
        os.replace(tmp, out)
    return str(out)


def bake_png(stem: str, img: np.ndarray) -> str:
    """img (H, W, 3|4) in [0, 1] as an 8-bit PNG (save_png's bytes) under
    the package's build directory; returns its path."""
    from .utils import imageio

    data = imageio.png_bytes(img)
    return _build_file(stem, ".png", data, lambda p: p.write_bytes(data))


def env_spot_exr() -> str:
    """A 64 x 128 lat-long sky (blue above, dim ground below) with a 3 x 3
    texel sun of radiance [40, 36, 30], as an EXR under the package's
    build directory; the sun holds most of the map's power, so its alias
    tables matter."""
    from .utils import imageio

    h, w = 64, 128
    cos_t = np.cos((np.arange(h) + 0.5) / h * np.pi)[:, None, None]
    sky = np.where(cos_t > 0.0, np.asarray([0.25, 0.35, 0.6]) * (0.4 + 0.6 * cos_t),
                   np.asarray([0.08, 0.07, 0.06]))
    img = np.broadcast_to(sky, (h, w, 3)).astype(np.float32).copy()
    img[13:16, 40:43] = [40.0, 36.0, 30.0]
    return _build_file("env_spot", ".exr", img.tobytes(), lambda p: imageio.save_exr(p, img))


def mesh_texture_png() -> str:
    """The reference's procedural 256 x 256 colour texture of the textured
    mesh-heavy scene (luisarender_tpu/testing.py:205-217), baked."""
    yy, xx = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    img = np.stack([
        0.5 + 0.45 * np.sin(xx * 0.11) * np.cos(yy * 0.07),
        0.5 + 0.45 * np.sin((xx + yy) * 0.05),
        0.5 + 0.45 * np.cos(xx * 0.03 - yy * 0.09),
    ], axis=-1).astype(np.float32)
    return bake_png("meshheavy_tex", img)


def cornell_textured(resolution=(48, 48), spp=8, depth=5):
    """The Cornell box with image textures on a surface and a light: the
    back wall's Kd is a 64 x 64 procedural PNG repeated twice across it
    (uv_scale 2, so its lookups blend mip levels), and the light's
    emission a 16 x 16 checker PNG of 1 and 0.25 scaled by the box's
    emission [17, 12, 4]; both quads get uvs. Neither texture is a
    constant, so the scene takes the general fork."""
    d = cornell_box(resolution=resolution, spp=spp, depth=depth)
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    wall = np.stack([
        0.55 + 0.4 * np.sin(xx * 0.35) * np.cos(yy * 0.2),
        0.55 + 0.4 * np.cos((xx - yy) * 0.15),
        0.45 + 0.35 * np.sin(yy * 0.3),
    ], axis=-1).astype(np.float32)
    cy, cx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    checker = np.where(((cy // 4 + cx // 4) % 2 == 0)[..., None], 1.0, 0.25)
    light_img = np.broadcast_to(checker, (16, 16, 3)).astype(np.float32)
    quad_uv = [0.0, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0]
    back = d["render"]["shapes"][2]["prop"]
    back["uvs"] = quad_uv
    back["surface"] = {"impl": "matte", "prop": {"Kd": {"impl": "image", "prop": {
        "file": bake_png("cornell_wall", wall), "uv_scale": [2.0, 2.0]}}}}
    light = d["render"]["shapes"][7]["prop"]
    light["uvs"] = quad_uv
    light["light"]["prop"]["emission"] = {"impl": "image", "prop": {
        "file": bake_png("cornell_light", light_img), "scale": list(LIGHT_EMISSION)}}
    return d


def mesh_heavy(res=(1280, 720), spp=4, depth=5, n=5, subdiv=5, accel="auto",
               textured=False):
    """The reference's bedroom-class scene (luisarender_tpu/testing.py
    mesh_heavy): n x n icosphere meshes (subdivision
    `subdiv`, 20 * 4^subdiv triangles each) with Disney surfaces over a
    1000 x 1000 floor quad with a checkerboard Kd, lit by a diffuse panel
    with a `null` surface and a constant spherical environment [0.4, 0.5,
    0.7]. The defaults give 512,004 triangles at 1280 x 720. The
    icospheres share one mesh, so `accel` "twolevel" keeps 3 unique meshes
    under n * n + 2 instances; "auto" takes that path from n = 20 at
    subdivision 5 (8,192,004 flattened triangles, 20,484 unique). As in the
    reference, the checkerboard's "scale" is no property of the texture
    (its scale is `uv_scale`), and the floor quad has no uvs, so the
    checkerboard reads its "on" colour everywhere while it still runs the
    texture evaluation. textured=True gives every sphere's Disney colour
    the reference's baked 256 x 256 PNG (mesh_texture_png) as an image
    texture with `encoding: "linear"`, which the reference decodes as sRGB
    all the same: one atlas entry with its mips, read at each hit's
    ray-cone level of detail. The dict renders on both packages."""

    def quad(p0, p1, p2, p3, surface, light=None):
        prop = {
            "positions": [c for p in (p0, p1, p2, p3) for c in p],
            "indices": [0, 1, 2, 0, 2, 3],
            "surface": surface,
        }
        if light:
            prop["light"] = light
        return {"impl": "inlinemesh", "prop": prop}

    checker = {"impl": "checkerboard", "prop": {
        "on": {"impl": "constant", "prop": {"v": [0.725, 0.71, 0.68]}},
        "off": {"impl": "constant", "prop": {"v": [0.2, 0.2, 0.25]}},
        "scale": [16.0, 16.0],
    }}
    floor_mat = {"impl": "matte", "prop": {"Kd": checker}}
    size = 1000.0
    shapes = [
        quad([0, 0, 0], [size, 0, 0], [size, 0, size], [0, 0, size], floor_mat),
        quad([350, 600, 350], [650, 600, 350], [650, 600, 650], [350, 600, 650],
             {"impl": "null", "prop": {}},
             light={"impl": "diffuse", "prop": {
                 "emission": {"impl": "constant", "prop": {"v": [8.0, 7.5, 7.0]}}}}),
    ]
    rough_tex = {"impl": "constant", "prop": {"v": [0.35]}}
    tex_file = mesh_texture_png() if textured else None
    for i in range(n):
        for j in range(n):
            color = [0.3 + 0.6 * i / max(n - 1, 1), 0.4, 0.9 - 0.6 * j / max(n - 1, 1)]
            color_tex = {"impl": "constant", "prop": {"v": color}}
            if textured:
                color_tex = {"impl": "image", "prop": {"file": tex_file, "encoding": "linear"}}
            mat = {
                "impl": "disney",
                "prop": {
                    "color": color_tex,
                    "metallic": {"impl": "constant", "prop": {"v": [0.5 * ((i + j) % 2)]}},
                    "roughness": rough_tex,
                },
            }
            shapes.append({
                "impl": "sphere",
                "prop": {
                    "analytic": False,  # the mesh pipeline is what it exercises
                    "subdivision": subdiv,
                    "surface": mat,
                    "transform": {"impl": "srt", "prop": {
                        "scale": [70, 70, 70],
                        "translate": [150 + 700 * i / max(n - 1, 1), 80,
                                      150 + 700 * j / max(n - 1, 1)],
                    }},
                },
            })
    return {
        "render": {
            "accel": accel,
            "cameras": [{
                "impl": "pinhole",
                "prop": {
                    "fov": 50.0,
                    "spp": spp,
                    "file": "mesh_heavy.exr",
                    "film": {"impl": "color", "prop": {"resolution": list(res)}},
                    "filter": {"impl": "box", "prop": {}},
                    "transform": {"impl": "view", "prop": {
                        "origin": [500.0, 350.0, -700.0],
                        "front": [0.0, -0.25, 1.0],
                        "up": [0.0, 1.0, 0.0],
                    }},
                },
            }],
            "integrator": {"impl": "megapath", "prop": {"depth": depth}},
            "environment": {"impl": "spherical", "prop": {
                "emission": {"impl": "constant", "prop": {"v": [0.4, 0.5, 0.7]}},
            }},
            "shapes": shapes,
        }
    }


def plastic_for_disney(d):
    """The scene dict `d` with each Disney surface replaced by a plastic one
    of the same colour and roughness (its other parameters dropped), as a
    scene renders under a spectrum that is not fixed: neither package can
    shade Disney there (surfaces/disney.py fixed_spectrum_only)."""

    def walk(shapes):
        for s in shapes:
            prop = s.get("prop", {})
            surf = prop.get("surface")
            if surf is not None and surf.get("impl") in ("disney", "Disney"):
                p = surf.get("prop", {})
                prop["surface"] = {"impl": "plastic", "prop": {
                    k: p[src] for k, src in (("Kd", "color"), ("roughness", "roughness"))
                    if src in p}}
            walk(prop.get("shapes", []))

    walk(d["render"]["shapes"])
    return d


def hero(d, dimension=4):
    """The scene dict `d` under the hero-wavelength spectrum of `dimension`
    wavelengths a path, its Disney surfaces made plastic
    (plastic_for_disney)."""
    d = plastic_for_disney(d)
    d["render"]["spectrum"] = {"impl": "hero", "prop": {"dimension": dimension}}
    return d
