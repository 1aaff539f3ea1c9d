"""Test scenes as JSON-SDL dicts: the Cornell box and the mesh-heavy scene,
their forms under the hero spectrum, a low-discrepancy sampler or the
wavepath integrator.

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


def bumps_png() -> str:
    """A 64 x 64 tangent-space normal map of a sinusoidal height field
    (normals * 0.5 + 0.5), baked as a PNG."""
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    k = 2.0 * np.pi / 16.0
    dx = 0.6 * np.cos(xx * k) * np.sin(yy * k)
    dy = 0.6 * np.sin(xx * k) * np.cos(yy * k)
    n = np.stack([-dx, -dy, np.ones_like(dx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return bake_png("bumps", (n * 0.5 + 0.5).astype(np.float32))


def _const(v):
    return {"impl": "constant", "prop": {"v": v}}


def _coat():
    """The coat both blocks wear: absorbing (sigma_a [0.2, 0.4, 0.8],
    thickness 0.5) and of roughness 0.3 (GGX alpha 0.09, near the 0.1 of
    Mitsuba's rough coating; a smooth coat, alpha 1e-4, lights the box
    with fireflies worth ten times its mean at 8 spp)."""
    return {"sigma_a": _const([0.2, 0.4, 0.8]), "thickness": _const([0.5]),
            "roughness": _const([0.3])}


def cornell_coated(resolution=(512, 512), spp=32, depth=8):
    """The Cornell box with the surfaces of the layered / mix slice:

    - tall block: a closed-form `layered` coat (`_coat`: sigma_a [0.2,
      0.4, 0.8], thickness 0.5, roughness 0.3) over gold `metal` of
      roughness 0.3;
    - short block: the same coat with the stochastic walk (`max_depth` 10,
      the default) over an orange `matte`;
    - back wall: a `mix` of red `matte` and blue `plastic`, its ratio a
      checkerboard of 0.2 / 0.8 (the wall gets uvs);
    - floor: white `matte` with a `normal_map`, bumps_png repeated 4 x 4
      (the floor gets uvs);
    - an analytic glass sphere whose `eta` is a checkerboard of 1.3 / 1.7,
      which renders with Cauchy (1.5, 0) as in the reference.

    It has 32 triangles and a sphere, so it traces with the brute-force
    kernels; mix, layered and the normal map keep it off the fused fork."""
    d = cornell_box(resolution=resolution, spp=spp, depth=depth)
    shapes = d["render"]["shapes"]
    quad_uv = [0.0, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0]
    floor = shapes[0]["prop"]
    floor["uvs"] = quad_uv
    floor["surface"] = {"impl": "matte", "prop": {
        "Kd": _const(WHITE),
        "normal_map": {"impl": "image", "prop": {"file": bumps_png(), "uv_scale": [4.0, 4.0]}}}}
    back = shapes[2]["prop"]
    back["uvs"] = quad_uv
    back["surface"] = {"impl": "mix", "prop": {
        "a": {"impl": "matte", "prop": {"Kd": _const(RED)}},
        "b": {"impl": "plastic", "prop": {"Kd": _const([0.2, 0.3, 0.7]),
                                          "roughness": _const([0.2])}},
        "ratio": {"impl": "checkerboard", "prop": {
            "on": _const([0.2]), "off": _const([0.8]), "uv_scale": [4.0, 4.0]}}}}
    shapes[5]["prop"]["surface"] = {"impl": "layered", "prop": {
        **_coat(), "stochastic": True,
        "base": {"impl": "matte", "prop": {"Kd": _const([0.8, 0.5, 0.2])}}}}
    shapes[6]["prop"]["surface"] = {"impl": "layered", "prop": {
        **_coat(), "base": {"impl": "metal", "prop": {"eta": "Au", "roughness": _const([0.3])}}}}
    shapes.append({"impl": "sphere", "prop": {
        "surface": {"impl": "glass", "prop": {"eta": {"impl": "checkerboard", "prop": {
            "on": _const([1.3]), "off": _const([1.7])}}}},
        "transform": {"impl": "srt", "prop": {"scale": [75, 75, 75],
                                              "translate": [420, 80, 130]}}}})
    return d


def motion_blur(resolution=(48, 16), spp=16, depth=2, shutter=True):
    """The reference's motion-blur scene (tests/test_motion_blur.py): a
    small emissive quad moving under `lerp` from x = -0.6 to 0.6 over the
    shutter [0, 1], 6 shutter samples, seen by a pinhole camera at 48 x 16."""
    move = {"impl": "lerp", "prop": {
        "transforms": [{"impl": "srt", "prop": {"translate": [-0.6, 0.0, 0.0]}},
                       {"impl": "srt", "prop": {"translate": [0.6, 0.0, 0.0]}}],
        "time_points": [0.0, 1.0]}}
    cam = {"fov": 45.0, "spp": spp, "file": "mb.exr",
           "film": {"impl": "color", "prop": {"resolution": list(resolution)}},
           "transform": {"impl": "view", "prop": {"origin": [0, 0, 2.5], "front": [0, 0, -1]}}}
    if shutter:
        cam["shutter_span"] = [0.0, 1.0]
        cam["shutter_samples"] = 6
    return {"render": {
        "cameras": [{"impl": "pinhole", "prop": cam}],
        "integrator": {"impl": "megapath", "prop": {"depth": depth}},
        "shapes": [{"impl": "inlinemesh", "prop": {
            "positions": [-0.15, -0.5, 0, 0.15, -0.5, 0, 0.15, 0.5, 0, -0.15, 0.5, 0],
            "indices": [0, 1, 2, 0, 2, 3],
            "surface": {"impl": "matte", "prop": {}},
            "light": {"impl": "diffuse", "prop": {"emission": _const([5.0, 5.0, 5.0])}},
            "transform": move}}]}}


def cornell_motion(resolution=(512, 512), spp=32, depth=8, shutter_samples=6):
    """The Cornell box with its short block moving under `lerp`: two `srt`
    keyframes 120 units apart along x at time_points [0, 1], a shutter
    span [0, 1] and `shutter_samples` buckets. Every surface stays matte,
    so each bucket renders on the fused fork."""
    d = cornell_box(resolution=resolution, spp=spp, depth=depth)
    d["render"]["shapes"][5]["prop"]["transform"] = {"impl": "lerp", "prop": {
        "transforms": [{"impl": "srt", "prop": {"translate": [0.0, 0.0, 0.0]}},
                       {"impl": "srt", "prop": {"translate": [120.0, 0.0, 0.0]}}],
        "time_points": [0.0, 1.0]}}
    cam = d["render"]["cameras"][0]["prop"]
    cam["shutter_span"] = [0.0, 1.0]
    cam["shutter_samples"] = shutter_samples
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


def with_sampler(d, impl, **props):
    """Scene d with its integrator's sampler set to `impl` (e.g. the goldens
    tests/golden/cornell_<impl>_32_4spp.exr: cornell_box((32, 32), 4 spp,
    depth 4) under each low-discrepancy sampler)."""
    d["render"]["integrator"]["prop"]["sampler"] = {"impl": impl, "prop": props}
    return d


def wavepath(d, **props):
    """Scene d rendered by the wavepath integrator at its integrator's
    depth, with `props` (state_count, iterations_per_launch, ...): the
    golden tests/golden/wavepath_32_8spp.exr is cornell_box((32, 32), 8
    spp, depth 4) with state_count 256 and iterations_per_launch 4."""
    d["render"]["integrator"] = {"impl": "wavepath", "prop": {
        "depth": d["render"]["integrator"]["prop"]["depth"], **props}}
    return d


# the fog sphere's box: scale 120 about [275, 180, 280]
FOG_BOUNDS = ([155.0, 60.0, 160.0], [395.0, 300.0, 400.0])


def fog(resolution=None, spp=None, depth=None):
    """scenes/fog.json (the Cornell box around a sphere of homogeneous fog,
    `megavpt`) as a dict, with its resolution (w, h), spp and depth
    replaced where given."""
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scenes" / "fog.json"
    d = json.loads(path.read_text())
    cam = d["render"]["cameras"][0]["prop"]
    if resolution is not None:
        cam["film"]["prop"]["resolution"] = list(resolution)
    if spp is not None:
        cam["spp"] = spp
    if depth is not None:
        d["render"]["integrator"]["prop"]["depth"] = depth
    return d


def fog_grid(resolution=(512, 512), spp=16, depth=10, dims=(32, 32, 32), seed=0):
    """fog() with the sphere's medium a `grid` over the sphere's box
    FOG_BOUNDS: the same sigma_a, sigma_s and `hg` g = 0.3, its density
    (dims (x, y, z), inline) a smooth field of eight Gaussian blobs over a
    floor of 0.2, made with numpy from `seed` and scaled so that its mean
    over the voxel centres inside the sphere is 1: the homogeneous fog's
    density, so a chord across the sphere has the fog's optical depth on
    average."""
    d = fog(resolution, spp, depth)
    sphere = d["render"]["shapes"][-1]["prop"]
    homog = sphere["medium"]["prop"]
    nx, ny, nz = dims
    rs = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.linspace(0.0, 1.0, k) for k in (nz, ny, nx)), indexing="ij")
    field = np.full((nz, ny, nx), 0.2)
    for _ in range(8):
        cx, cy, cz = rs.uniform(0.2, 0.8, 3)
        width = rs.uniform(0.08, 0.2)
        field += rs.uniform(0.5, 1.5) * np.exp(
            -((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) / (2.0 * width * width))
    inside = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2 <= 0.25
    field = (field / field[inside].mean()).astype(np.float32)
    sphere["medium"] = {"impl": "grid", "prop": {
        "sigma_a": homog["sigma_a"], "sigma_s": homog["sigma_s"], "phase": homog["phase"],
        "bounds_min": FOG_BOUNDS[0], "bounds_max": FOG_BOUNDS[1],
        "dimensions": [nx, ny, nz], "density": [float(v) for v in field.reshape(-1)]}}
    return d
