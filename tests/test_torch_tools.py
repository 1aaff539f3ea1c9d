"""The port's scene and image tools and its IES parser against the
reference's (luisarender_tpu/tools/*.py, luisarender_tpu/utils/ies.py) on
the CPU, on the inputs the reference's own tool tests build.

Tolerances: the converters' scene dicts equal after each side's output
directory is replaced by one token; their side files (OBJ meshes, the AVI,
PNGs both sides write with the same writer) byte-equal; PNGs that Pillow
writes on the reference's side (glTF textures) equal in decoded pixels;
IES arrays and lookups equal; tone mapping within 1e-6 on the linear
values and one 8-bit level in the PNG. And the one golden no other port
test renders, tests/golden/tungsten_converted_48x32_8spp.exr, from the
port's converter: its general fork by tests/test_golden.py's rule, its
default route (the fused fork's ray-input mode) by the fused goldens' rule.
"""

import base64
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)
from test_disney_convert import _mini_project
from test_gltf import _make_glb
from test_mitsuba import XML as MITSUBA_XML
from test_tools_misc import _make_akr_mesh
from test_tungsten import _write_wo3

from luisarender_tpu.tools import (
    akr2obj as r_akr2obj,
    disney2scene as r_disney,
    glslpt2scene as r_glslpt,
    gltf2scene as r_gltf,
    hdr2srgb as r_hdr2srgb,
    image_channels as r_channels,
    lux2scene as r_lux,
    mitsuba2scene as r_mitsuba,
    obj2scene as r_obj2scene,
    obj_analyse as r_obj_analyse,
    seq2video as r_seq2video,
    split_obj as r_split_obj,
    tonemap as r_tonemap,
    tungsten2scene as r_tungsten,
)
from luisarender_tpu.utils import ies as r_ies
from luisarender_tpu.utils import imageio as r_imageio
from luisarender_tpu_torch.tools import (
    akr2obj,
    disney2scene,
    glslpt2scene,
    gltf2scene,
    hdr2srgb,
    image_channels,
    lux2scene,
    mitsuba2scene,
    obj2scene,
    obj_analyse,
    seq2video,
    split_obj,
    tonemap,
    tungsten2scene,
)
from luisarender_tpu_torch.utils import ies, imageio

ROOT = Path(__file__).resolve().parent.parent
TUNGSTEN_GOLDEN = ROOT / "tests" / "golden" / "tungsten_converted_48x32_8spp.exr"


def _tokened(obj, *dirs):
    """A JSON-able object as text with each output directory replaced by
    one token."""
    text = json.dumps(obj, sort_keys=True)
    for d in dirs:
        text = text.replace(str(d), "<OUT>")
    return text


def _same_files(a_dir, b_dir, pattern="*"):
    a = sorted(p.relative_to(a_dir) for p in Path(a_dir).rglob(pattern) if p.is_file())
    b = sorted(p.relative_to(b_dir) for p in Path(b_dir).rglob(pattern) if p.is_file())
    assert a == b and a
    for rel in a:
        assert (Path(a_dir) / rel).read_bytes() == (Path(b_dir) / rel).read_bytes(), rel
    return a


# --------------------------------------------------------------------------
# utils/ies.py
# --------------------------------------------------------------------------

_IES = {
    # tests/test_imageio.py's profile: 3 vertical angles, 1 horizontal
    "one_plane": """IESNA:LM-63-2002
[TEST] sample
TILT=NONE
1 1000.0 1.0 3 1 1 1 0.1 0.1 0.1
1.0 1.0 60.0
0.0 90.0 180.0
0.0
1000.0 500.0 0.0
""",
    # quadrant symmetry (h up to 90), a multiplier, numbers across lines
    "quadrant": """IESNA91
[MANUFAC] test
TILT=NONE
1 -1 2.0 4 3 1 2 0.5 0.5 0.0
1.0 1.0 100.0
0 30 60 90
0 45
90
900 800 400 0 850 700 300 0
800 600 200 0
""",
    # bilateral symmetry (h up to 180) and tilt data to skip
    "bilateral_tilt": """IESNA:LM-63-1995
TILT=INCLUDE
1
3
0 45 90
1.0 0.9 0.7
1 1200.0 1.0 3 3 1 1 0.2 0.2 0.1
1.0 1.0 75.0
0 90 180
0 90 180
500 250 10
400 200 5
300 100 0
""",
}


@pytest.mark.parametrize("name", sorted(_IES))
def test_ies_profile_matches_reference(tmp_path, name):
    p = tmp_path / f"{name}.ies"
    p.write_text(_IES[name])
    ref, port = r_ies.IESProfile.parse(p), ies.IESProfile.parse(p)
    for k in ("v_angles", "h_angles", "candela"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    theta = np.linspace(-10.0, 190.0, 41)[:, None]
    phi = np.linspace(-30.0, 400.0, 37)[None, :]
    np.testing.assert_array_equal(port.intensity(theta, phi), ref.intensity(theta, phi))
    img = port.rasterize((16, 32))
    np.testing.assert_array_equal(img, ref.rasterize((16, 32)))
    assert img.dtype == np.float32 and img.max() == 1.0


# --------------------------------------------------------------------------
# OBJ and mesh utilities
# --------------------------------------------------------------------------


def test_split_obj_matches_reference(tmp_path):
    _mini_project(tmp_path)
    # a face before any group, uv / normal index forms and an `o` record
    obj = tmp_path / "isle.obj"
    obj.write_text("v 9 9 9\nvt 0.5 0.5\nvn 0 1 0\nf 1/1/1 1/1/1 1/1/1\n"
                   + obj.read_text() + "o extra part\nf 1//1 2//1 3//1\nf 2/1 3/1 4/1\n")
    ref = r_split_obj.split_obj(obj, tmp_path / "ref")
    port = split_obj.split_obj(obj, tmp_path / "port")
    assert _tokened(port, tmp_path / "port") == _tokened(ref, tmp_path / "ref")
    assert len(port) == 4
    _same_files(tmp_path / "ref", tmp_path / "port")


def test_akr2obj_matches_reference(tmp_path):
    mesh = tmp_path / "m.mesh"
    _make_akr_mesh(str(mesh))
    ref = r_akr2obj.akr_to_obj(str(mesh), str(tmp_path / "ref.obj"))
    port = akr2obj.akr_to_obj(str(mesh), str(tmp_path / "port.obj"))
    assert Path(port).read_bytes() == Path(ref).read_bytes()
    assert akr2obj.akr_to_obj(str(mesh)) == str(tmp_path / "m.obj")
    with pytest.raises(ValueError):
        akr2obj.akr_to_obj(str(tmp_path / "m.obj"))


def test_obj_analyse_matches_reference(tmp_path):
    (tmp_path / "a.obj").write_text(
        "# comment\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 0\nv 1 1 0\n"
        "f 1 2 3\nf 4 2 3\nf -1 -3 -4 -5\n")
    (tmp_path / "b.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1/1/1 2/2/2 3/3/3\n")
    for f in ("a.obj", "b.obj"):
        assert obj_analyse.analyse_obj(str(tmp_path / f)) == \
            r_obj_analyse.analyse_obj(str(tmp_path / f))
    vs, fs = set(), set()
    rvs, rfs = set(), set()
    for f in ("a.obj", "b.obj"):
        obj_analyse.analyse_obj(str(tmp_path / f), vs, fs)
        r_obj_analyse.analyse_obj(str(tmp_path / f), rvs, rfs)
    assert (vs, fs) == (rvs, rfs)


# --------------------------------------------------------------------------
# image tools
# --------------------------------------------------------------------------


def _hdr(seed, shape=(9, 13, 3), specials=False):
    """Linear HDR pixels; with `specials`, a NaN, an inf and a negative
    sample in the first pixel."""
    rng = np.random.default_rng(seed)
    img = np.abs(rng.normal(size=shape)).astype(np.float32) * 3.0
    if specials:
        img[0, 0, :3] = [np.nan, np.inf, -1.0]
    return img


def test_seq2video_matches_reference(tmp_path, capsys):
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        for i in range(3):
            img = np.full((16, 24, 3), i * 0.3, np.float32)
            img[i, :, 1] = 2.0
            imageio.save_exr(str(d / f"f{i}.exr"), img)
        imageio.save_exr(str(d / "dump-0.exr"), np.ones((16, 24, 3), np.float32))
    r_seq2video.main([str(tmp_path / "ref"), "12"])
    seq2video.main([str(tmp_path / "port"), "12"])
    files = _same_files(tmp_path / "ref", tmp_path / "port")
    assert {str(f) for f in files} >= {"output.avi", "f0.png", "f1.png", "f2.png"}
    frames = np.random.default_rng(3).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    seq2video.write_avi(tmp_path / "odd_port.avi", frames, 7)
    r_seq2video.write_avi(tmp_path / "odd_ref.avi", frames, 7)
    assert (tmp_path / "odd_port.avi").read_bytes() == (tmp_path / "odd_ref.avi").read_bytes()


@pytest.mark.parametrize("exposure", [0.0, 1.5])
def test_hdr2srgb_matches_reference(tmp_path, exposure, capsys):
    img = _hdr(0, specials=True)
    np.testing.assert_array_equal(hdr2srgb.hdr_to_srgb(img, exposure),
                                  r_hdr2srgb.hdr_to_srgb(img, exposure))
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
        imageio.save_exr(str(tmp_path / side / "in.exr"), img)
    r_hdr2srgb.main([str(tmp_path / "ref" / "in.exr"), str(exposure)])
    hdr2srgb.main([str(tmp_path / "port" / "in.exr"), str(exposure)])
    _same_files(tmp_path / "ref", tmp_path / "port")


def _rgba_png(path, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(6, 10, 4)).astype(np.float32)
    imageio.save_png(path, img)


@pytest.mark.parametrize("ext", ["exr", "png"])
@pytest.mark.parametrize("mode", ["rgb", "trans"])
def test_image_channels_match_reference(tmp_path, mode, ext, capsys):
    """A PNG is decoded by Pillow on the reference's side and by the port's
    own decoder; both write with the same PNG writer, so the files are
    byte-equal when the decoded samples are."""
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
        src = tmp_path / side / f"in.{ext}"
        if ext == "exr":
            imageio.save_exr(str(src), _hdr(1, (6, 10, 4)) / 4.0)
        else:
            _rgba_png(src, 2)
    r_channels.main([mode, str(tmp_path / "ref" / f"in.{ext}")])
    image_channels.main([mode, str(tmp_path / "port" / f"in.{ext}")])
    files = _same_files(tmp_path / "ref", tmp_path / "port")
    assert len(files) == 2


def test_image_channels_refuse_jpeg(tmp_path):
    """The port decodes PNG itself and has no JPEG decoder (the card's
    machine has no Pillow): where the reference reads a JPEG through Pillow,
    the port raises (ROADMAP Queue 3, deliberate differences)."""
    from PIL import Image

    src = tmp_path / "in.jpg"
    Image.new("RGBA", (4, 4), (10, 20, 30, 255)).convert("RGB").save(src)
    with pytest.raises(ValueError, match="not a PNG"):
        image_channels.rgba_to_rgb(str(src))
    assert r_imageio.load_image(src).shape == (4, 4, 4)


@pytest.mark.parametrize("exposure", [-1.0, 0.0, 2.0])
@pytest.mark.parametrize("operator", ["none", "uncharted2", "aces"])
def test_tonemap_image_matches_reference(operator, exposure):
    img = _hdr(4, (8, 8, 3))
    img[0, 0] = 0.0
    port = tonemap.tonemap_image(img, operator, exposure, device="cpu")
    ref = r_tonemap.tonemap_image(img, operator, exposure)
    assert port.shape == img.shape and port.dtype == np.float32
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("out_ext", ["png", "exr"])
def test_tonemap_main_matches_reference(tmp_path, out_ext, capsys):
    img = _hdr(5, (8, 8, 3))
    src = tmp_path / "in.exr"
    imageio.save_exr(str(src), img)
    args = ["--tonemap", "aces", "--exposure", "-1"]
    r_tonemap.main([str(src), str(tmp_path / f"ref.{out_ext}")] + args)
    tonemap.main([str(src), str(tmp_path / f"port.{out_ext}")] + args, device="cpu")
    if out_ext == "exr":
        np.testing.assert_allclose(imageio.load_exr(tmp_path / "port.exr"),
                                   imageio.load_exr(tmp_path / "ref.exr"), rtol=0, atol=1e-6)
    else:
        a = imageio.png_rgba8(tmp_path / "port.png").astype(np.int32)
        b = imageio.png_rgba8(tmp_path / "ref.png").astype(np.int32)
        assert np.abs(a - b).max() <= 1
    with pytest.raises(ValueError, match="unknown tone mapping"):
        tonemap.tonemap_image(img, "filmic", device="cpu")


def test_tonemap_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tonemap.tonemap_image(np.ones((2, 2, 3), np.float32))


# --------------------------------------------------------------------------
# converters
# --------------------------------------------------------------------------

_LUX = (
    'scene.camera.lookat.orig = 0.0 1.0 5.0\n'
    'scene.camera.lookat.target = 0.0 1.0 0.0\n'
    'scene.camera.up = 0.0 1.0 0.0\n'
    'scene.camera.fieldofview = 49.0\n'
    'scene.textures.white.type = "constfloat3"\n'
    'scene.textures.white.value = 0.8 0.8 0.8\n'
    'scene.textures.emit.type = "constfloat3"\n'
    'scene.textures.emit.value = 10 10 10\n'
    'scene.textures.wood.type = "imagemap"\n'
    'scene.textures.wood.file = "wood.png"\n'
    'scene.textures.wood.gamma = 2.2\n'
    'scene.textures.wood.gain = 1.0\n'
    'scene.textures.wood.mapping.uvscale = 2 3\n'
    'scene.textures.wood.mapping.uvdelta = 0.5 0.25\n'
    'scene.textures.rough.type = "constfloat1"\n'
    'scene.textures.rough.value = 0.3\n'
    'scene.materials.wall.type = "matte"\n'
    'scene.materials.wall.kd = "white"\n'
    'scene.materials.wall.emission.power = 0\n'
    'scene.materials.table.type = "roughmatte"\n'
    'scene.materials.table.kd = "wood"\n'
    'scene.materials.table.sigma = "rough"\n'
    'scene.materials.pane.type = "glass"\n'
    'scene.materials.pane.kr = "white"\n'
    'scene.materials.pane.kt = "white"\n'
    'scene.materials.pane.transparency = "rough"\n'
    'scene.materials.lamp.type = "matte"\n'
    'scene.materials.lamp.kd = "white"\n'
    'scene.materials.lamp.emission = "emit"\n'
    'scene.objects.floor.ply = "floor.ply"\n'
    'scene.objects.floor.material = "wall"\n'
    'scene.objects.top.ply = "top.ply"\n'
    'scene.objects.top.material = "table"\n'
    'scene.objects.top.transformation = 1 0 0 0 0 1 0 0 0 0 1 0 2 3 4 1\n'
    'scene.objects.glass.ply = "glass.ply"\n'
    'scene.objects.glass.material = "pane"\n'
    'scene.objects.lampshape.ply = "lamp.ply"\n'
    'scene.objects.lampshape.material = "lamp"\n'
)


def test_lux2scene_matches_reference(tmp_path, capsys):
    scn = tmp_path / "box.scn"
    scn.write_text(_LUX)
    ref = json.loads(Path(r_lux.convert(str(scn), str(tmp_path / "ref.json"))).read_text())
    port = json.loads(Path(lux2scene.convert(str(scn), str(tmp_path / "port.json"))).read_text())
    assert port == ref
    assert lux2scene.convert(str(scn)) == str(tmp_path / "box.json")
    assert (tmp_path / "box.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


_GLSLPT = (
    "renderer\n{\n resolution 640 360\n envmapfile sky.hdr\n envmapintensity 2\n}\n"
    "material red\n{\n color 0.9 0.1 0.1\n roughness 0.25\n metallic 0.5\n}\n"
    "material glass\n{\n color 1 1 1\n spectrans 1.0\n ior 1.45\n"
    " albedotexture tex/albedo.png\n metallicroughnesstexture tex/mr.png\n}\n"
    "light\n{\n type quad\n position -1 5 -1\n v1 1 5 -1\n v2 -1 5 1\n"
    " emission 20 20 20\n}\n"
    "light\n{\n type sphere\n position 2 3 0\n radius 0.25\n emission 5 5 5\n}\n"
    "mesh\n{\n file bunny.obj\n material red\n"
    " position 0 0 0\n scale 2 2 2\n rotation 0.92 0 0.38 0\n}\n"
    "mesh\n{\n file bunny.obj\n material glass\n position 1 0 0\n}\n"
    "camera\n{\n position 0 1 4\n lookat 0 1 0\n fov 60\n aperture 0.1\n"
    " focaldist 4\n}\n"
)


def test_glslpt2scene_matches_reference(tmp_path, capsys):
    sc = tmp_path / "demo.scene"
    sc.write_text(_GLSLPT)
    ref = json.loads(Path(r_glslpt.convert(str(sc), str(tmp_path / "ref.json"))).read_text())
    port = json.loads(Path(glslpt2scene.convert(str(sc), str(tmp_path / "port.json"))).read_text())
    assert port == ref
    kinds = [s["impl"] for s in port["render"]["shapes"]]
    assert "inlinemesh" in kinds and "instance" in kinds


def test_obj2scene_matches_reference(tmp_path, capsys):
    (tmp_path / "model.mtl").write_text(
        "newmtl wall\nKd 0.8 0.7 0.6\nNs 20\n"
        "newmtl lamp\nKd 0 0 0\nKe 12 11 10\n"
        "newmtl chrome\nKs 0.9 0.9 0.9\nNs 800\n"
        "newmtl pane\nKd 1 1 1\nd 0.2\nNi 1.5\nmap_Kd textures/pane.png\n")
    (tmp_path / "model.obj").write_text(
        "mtllib model.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvn 0 0 1\n"
        "f 1 2 3\nusemtl wall\nf 1 2 3\nf 1 3 4\nusemtl lamp\nf 1/1/1 2/1/1 3/1/1\n"
        "usemtl chrome\nf 2 3 4\nusemtl pane\nf 1 2 4\nusemtl wall\nf 4 3 2\n")
    for side, main in (("ref", r_obj2scene.main), ("port", obj2scene.main)):
        assert main([str(tmp_path / "model.obj"), "-o", str(tmp_path / side / "s.json"),
                     "--spp", "16", "--resolution", "64", "48"]) == 0
    ref = json.loads((tmp_path / "ref" / "s.json").read_text())
    port = json.loads((tmp_path / "port" / "s.json").read_text())
    assert _tokened(port, tmp_path / "port") == _tokened(ref, tmp_path / "ref")
    files = _same_files(tmp_path / "ref", tmp_path / "port", "*.obj")
    assert len(files) == 5


def _tungsten_input(d):
    """tests/test_tungsten.py's scene, with a plastic, a mirror and a thin
    sheet, a disk and a light given by its power, a directional cap and a
    mesh file that is not a .wo3."""
    pos = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32)
    nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tris = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    _write_wo3(d / "floor.wo3", pos, nrm, uv, tris)
    scene = {
        "renderer": {"spp": 4},
        "integrator": {"type": "path_tracer", "max_bounces": 3},
        "camera": {"transform": {"position": [0, 1.0, -4.0], "look_at": [0, 0.5, 0],
                                 "up": [0, 1, 0]},
                   "resolution": [32, 24], "fov": 60},
        "bsdfs": [
            {"name": "white", "type": "lambert", "albedo": 0.7},
            {"name": "glassy", "type": "rough_dielectric", "ior": 1.5, "roughness": 0.2,
             "albedo": [0.9, 0.9, 0.9]},
            {"name": "metal", "type": "rough_conductor", "material": "Au",
             "roughness": 0.3, "albedo": 1.0},
            {"name": "checks", "type": "lambert",
             "albedo": {"type": "checker", "on_color": 0.8, "off_color": [0.1, 0.2, 0.3],
                        "res_u": 10, "res_v": 10}},
            {"name": "shiny", "type": "rough_plastic", "ior": 1.4, "roughness": 0.05,
             "albedo": "textures/wood.png"},
            {"name": "glassplate", "type": "thinsheet", "albedo": 1.0},
            {"name": "oddity", "type": "transparency", "albedo": 0.5},
        ],
        "primitives": [
            {"type": "mesh", "file": "floor.wo3", "bsdf": "checks"},
            {"type": "mesh", "file": "models/teapot.obj", "bsdf": "shiny"},
            {"type": "quad", "transform": {"position": [0, 2.0, 0], "scale": [2, 1, 2],
                                           "rotation": [180, 0, 0]},
             "bsdf": {"type": "null"}, "emission": [6.0, 6.0, 6.0]},
            {"type": "sphere", "transform": {"position": [-0.7, 0.5, 0], "scale": 1.0},
             "bsdf": "metal"},
            {"type": "cube", "transform": {"position": [0.8, 0.35, 0],
                                           "scale": [0.7, 0.7, 0.7], "rotation": [0, 30, 0]},
             "bsdf": "white"},
            {"type": "disk", "transform": {"position": [0, 1, 1], "scale": [0.5, 1, 0.5]},
             "bsdf": "glassy", "power": 40.0},
            {"type": "curves", "bsdf": "white"},
            {"type": "infinite_sphere", "emission": [0.1, 0.12, 0.15]},
            {"type": "infinite_sphere_cap", "power": 80.0, "cap_angle": 3.0,
             "transform": {"rotation": [45, 10, 0]}},
        ],
    }
    (d / "scene.json").write_text(json.dumps(scene))
    return d / "scene.json"


def test_tungsten2scene_matches_reference(tmp_path, capsys):
    src = _tungsten_input(tmp_path)
    ref = r_tungsten.convert(str(src), str(tmp_path / "ref" / "out.json"))
    port = tungsten2scene.convert(str(src), str(tmp_path / "port" / "out.json"))
    assert _tokened(port, tmp_path / "ref", tmp_path / "port") == \
        _tokened(ref, tmp_path / "ref", tmp_path / "port")
    assert _tokened(json.loads((tmp_path / "port" / "out.json").read_text()),
                    tmp_path / "port") == \
        _tokened(json.loads((tmp_path / "ref" / "out.json").read_text()), tmp_path / "ref")
    assert _same_files(tmp_path / "ref" / "assets", tmp_path / "port" / "assets") == \
        [Path("floor.obj")]
    p, t = tungsten2scene.read_wo3(tmp_path / "floor.wo3")
    rp, rt = r_tungsten.read_wo3(tmp_path / "floor.wo3")
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(t, rt)


@pytest.mark.parametrize("material", [
    {"type": "mirror", "albedo": [1, 0.8, 0.6]},
    {"type": "plastic", "ior": 1.4, "albedo": 0.5},
    {"type": "conductor", "material": "Ag"},
    {"type": "conductor", "material": "Unobtainium"},
    {"type": "oren_nayar", "sigma": 0.35},
    {"type": "dielectric", "albedo": {"type": "constant", "value": 0.9}},
    {"type": "lambert", "albedo": {"type": "bitmap", "file": "a.png"}},
], ids=["mirror", "plastic", "conductor", "unknown_metal", "oren_nayar", "dielectric",
        "bitmap"])
def test_tungsten_material_mapping_matches_reference(material):
    assert tungsten2scene.convert_material(material) == r_tungsten.convert_material(material)


def test_mitsuba2scene_matches_reference(tmp_path, capsys):
    p = tmp_path / "scene.xml"
    p.write_text(MITSUBA_XML)
    ref = r_mitsuba.convert(str(p), str(tmp_path / "ref.json"))
    port = mitsuba2scene.convert(str(p), str(tmp_path / "port.json"))
    assert port == ref
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert mitsuba2scene.main([str(p), str(tmp_path / "main.json")]) == 0
    assert json.loads((tmp_path / "main.json").read_text()) == ref


def test_disney2scene_matches_reference(tmp_path):
    _mini_project(tmp_path)
    ref = r_disney.convert_project(tmp_path, tmp_path / "ref")
    port = disney2scene.convert_project(tmp_path, tmp_path / "port")
    assert Path(port).name == Path(ref).name
    assert _tokened(json.loads(Path(port).read_text()), tmp_path / "port") == \
        _tokened(json.loads(Path(ref).read_text()), tmp_path / "ref")
    files = _same_files(tmp_path / "ref", tmp_path / "port", "*.obj")
    assert len(files) == 2


# --------------------------------------------------------------------------
# glTF
# --------------------------------------------------------------------------


def _texture_png(kind):
    """PNG bytes of a small texture: RGB by the port's writer, a palette
    image and an RGBA one by Pillow's."""
    from PIL import Image

    rng = np.random.default_rng(7)
    if kind == "rgb":
        return imageio.png_bytes(rng.uniform(size=(5, 7, 3)).astype(np.float32))
    img = Image.fromarray(rng.integers(0, 256, (5, 7, 4), dtype=np.uint8), "RGBA")
    if kind == "palette":
        img = img.convert("RGB").convert("P", palette=Image.Palette.ADAPTIVE, colors=6)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _textured_glb(path, image_bytes, where):
    """tests/test_gltf.py's GLB with its material's base colour, normal map
    and emission read from one image: in the binary buffer (`bufferview`),
    a data URI (`datauri`) or a file beside the GLB (`file`)."""
    _make_glb(path)
    raw = path.read_bytes()
    js_len = struct.unpack_from("<I", raw, 12)[0]
    doc = json.loads(raw[20:20 + js_len].decode())
    bin_data = raw[20 + js_len + 8:]
    image = {"mimeType": "image/png"}
    if where == "bufferview":
        pad = (-len(bin_data)) % 4
        bin_data += b"\x00" * pad
        doc["bufferViews"].append({"buffer": 0, "byteOffset": len(bin_data),
                                   "byteLength": len(image_bytes)})
        bin_data += image_bytes + b"\x00" * ((-len(image_bytes)) % 4)
        doc["buffers"][0]["byteLength"] = len(bin_data)
        image["bufferView"] = len(doc["bufferViews"]) - 1
    elif where == "datauri":
        image["uri"] = "data:image/png;base64," + base64.b64encode(image_bytes).decode()
    else:
        (path.parent / "albedo.img").write_bytes(image_bytes)
        image["uri"] = "albedo.img"
    doc["images"] = [image]
    doc["textures"] = [{"source": 0}]
    mat = doc["materials"][0]
    mat["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
    mat["normalTexture"] = {"index": 0}
    mat["emissiveTexture"] = {"index": 0}
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_data)
    path.write_bytes(struct.pack("<4sII", b"glTF", 2, total)
                     + struct.pack("<I4s", len(js), b"JSON") + js
                     + struct.pack("<I4s", len(bin_data), b"BIN\x00") + bin_data)


def test_gltf2scene_matches_reference(tmp_path):
    glb = tmp_path / "quad.glb"
    _make_glb(glb)
    ref = r_gltf.convert(str(glb), str(tmp_path / "ref" / "scene.json"), spp=4)
    port = gltf2scene.convert(str(glb), str(tmp_path / "port" / "scene.json"), spp=4)
    assert port == ref
    _same_files(tmp_path / "ref", tmp_path / "port")
    # the reference's test of an interleaved buffer, on both parsers
    pos = np.asarray([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.float32)
    uv = np.asarray([[9, 10], [11, 12], [13, 14]], np.float32)
    inter = np.concatenate([pos, uv], axis=1).astype(np.float32).tobytes()
    doc = {"asset": {"version": "2.0"},
           "buffers": [{"byteLength": len(inter), "uri": "data:application/octet-stream;base64,"
                        + base64.b64encode(inter).decode()}],
           "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(inter),
                            "byteStride": 20}],
           "accessors": [
               {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
               {"bufferView": 0, "byteOffset": 12, "componentType": 5126, "count": 3,
                "type": "VEC2"},
               {"componentType": 5121, "count": 2, "type": "SCALAR"}]}
    p = tmp_path / "strided.gltf"
    p.write_text(json.dumps(doc))
    g, rg = gltf2scene.GltfFile(p), r_gltf.GltfFile(p)
    for i in range(3):
        np.testing.assert_array_equal(g.accessor(i), rg.accessor(i))
    np.testing.assert_array_equal(g.accessor(0), pos)


@pytest.mark.parametrize("kind,where", [("rgb", "bufferview"), ("palette", "datauri"),
                                        ("rgba", "file")])
def test_gltf_png_texture_matches_reference(tmp_path, kind, where):
    """The port decodes the embedded PNG itself and writes it with its own
    writer; the reference goes through Pillow both ways, so the files are
    compared by their decoded pixels."""
    from PIL import Image

    glb = tmp_path / "tex.glb"
    _textured_glb(glb, _texture_png(kind), where)
    ref = r_gltf.convert(str(glb), str(tmp_path / "ref" / "scene.json"), spp=4)
    port = gltf2scene.convert(str(glb), str(tmp_path / "port" / "scene.json"), spp=4)
    assert port == ref
    prop = port["render"]["shapes"][0]["prop"]
    assert prop["surface"]["prop"]["color"]["impl"] == "image"
    assert prop["light"]["prop"]["emission"]["impl"] == "image"
    name = prop["surface"]["prop"]["color"]["prop"]["file"]
    a = imageio.png_rgba8(tmp_path / "port" / name)
    b = np.asarray(Image.open(tmp_path / "ref" / name).convert("RGBA"))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, imageio.png_rgba8(tmp_path / "ref" / name))
    _same_files(tmp_path / "ref", tmp_path / "port", "*.obj")


def test_gltf_jpeg_texture_keeps_the_factors(tmp_path, capsys):
    """No JPEG decoder in the port (the card's machine has no Pillow): the
    texture takes the reference's own warning path, and the material keeps
    its factors where the reference with Pillow extracts the image (ROADMAP
    Queue 3, deliberate differences)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (4, 4), (200, 30, 30)).save(buf, format="JPEG")
    glb = tmp_path / "jpeg.glb"
    _textured_glb(glb, buf.getvalue(), "bufferview")
    port = gltf2scene.convert(str(glb), str(tmp_path / "port" / "scene.json"), spp=4)
    assert "warning: could not extract texture 0" in capsys.readouterr().err
    prop = port["render"]["shapes"][0]["prop"]
    assert prop["surface"]["prop"]["color"] == {"impl": "constant",
                                                "prop": {"v": [0.2, 0.2, 0.2]}}
    assert "normal_map" not in prop["surface"]["prop"]
    assert prop["light"]["prop"]["emission"] == {"impl": "constant",
                                                 "prop": {"v": [1.0, 0.1, 0.1]}}
    assert not list((tmp_path / "port").glob("*.png"))
    ref = r_gltf.convert(str(glb), str(tmp_path / "ref" / "scene.json"), spp=4)
    assert ref["render"]["shapes"][0]["prop"]["surface"]["prop"]["color"]["impl"] == "image"
    _same_files(tmp_path / "ref", tmp_path / "port", "*.obj")


# --------------------------------------------------------------------------
# the Tungsten golden, rendered by the port from its own converter
# --------------------------------------------------------------------------


def _golden_tungsten_scene(d):
    """tests/test_golden.py test_golden_tungsten_converted's inputs."""
    pos = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32)
    nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tris = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    _write_wo3(d / "floor.wo3", pos, nrm, uv, tris)
    tscene = {
        "renderer": {"spp": 8},
        "integrator": {"type": "path_tracer", "max_bounces": 4},
        "camera": {"transform": {"position": [0, 1.5, -4.0], "look_at": [0, 0.3, 0],
                                 "up": [0, 1, 0]},
                   "resolution": [48, 32], "fov": 60},
        "bsdfs": [{"name": "white", "type": "lambert", "albedo": 0.7},
                  {"name": "metal", "type": "rough_conductor", "material": "Cu",
                   "roughness": 0.3}],
        "primitives": [
            {"type": "mesh", "file": "floor.wo3", "bsdf": "white"},
            {"type": "sphere", "transform": {"position": [0, 0.5, 0], "scale": 0.5},
             "bsdf": "metal"},
            {"type": "quad", "transform": {"position": [0, 3.0, 0], "scale": [2.0, 1.0, 2.0]},
             "emission": [6.0, 6.0, 6.0], "bsdf": "white"},
        ],
    }
    (d / "scene.json").write_text(json.dumps(tscene))
    return tungsten2scene.convert(str(d / "scene.json"), str(d / "out.json"))


def _frac_off(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) > 1e-3).mean())


def test_tungsten_golden_general_fork(tmp_path, monkeypatch, capsys):
    """The general fork (the brute kernels' plain versions on the CPU)
    against the golden at tests/test_golden.py _check's tolerance."""
    import luisarender_tpu_torch as lt

    monkeypatch.setenv("LUISARENDER_TPU_NO_FUSED", "1")
    scene = lt.Scene.from_dict(_golden_tungsten_scene(tmp_path))
    img = next(iter(lt.render(scene, device="cpu").values()))
    assert scene.integrator.fused_passes == 0 and scene.integrator.bounces_run > 0
    ref = imageio.load_exr(str(TUNGSTEN_GOLDEN))
    assert img.shape == ref.shape == (32, 48, 3)
    mad, mx = float(np.abs(img - ref).mean()), float(np.abs(img - ref).max())
    assert mad < 2e-5 and mx < 2e-3, (mad, mx)


def test_tungsten_golden_default_route(tmp_path, capsys):
    """The default route: the converted camera has a gaussian filter, so the
    fused fork takes its ray-input mode (camgen_params is None); held as the
    fused goldens are held: the image's mean within 0.5%, each sample of the
    fused fork against the general fork by the reference's rule (ray counts,
    under 2% of pixels off by more than 1e-3), and the general fork's image
    under that rule against the golden."""
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch.integrators.mega_path import (
        general_path_trace_batch, path_trace_batch, pixel_grid,
    )
    from luisarender_tpu_torch.ops import fused_path as fp

    scene = lt.Scene.from_dict(_golden_tungsten_scene(tmp_path))
    img = next(iter(lt.render(scene, device="cpu").values()))
    integ, cam = scene.integrator, scene.cameras[0]
    assert integ.fused_passes == 8 and integ.bounces_run == 0
    assert fp.camgen_params(cam, integ.sampler.seed) is None
    ref = imageio.load_exr(str(TUNGSTEN_GOLDEN))
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005
    comp = lt.compile_scene(scene, device="cpu")
    assert comp.plan.fused_path and comp.plan.num_tris == 4 and comp.plan.num_spheres == 1
    pxy = pixel_grid(48, 32, comp.device)
    kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth,
              rr_threshold=integ.rr_threshold)
    acc = 0.0
    for si in range(8):
        args = (comp, cam, integ.sampler, integ.light_sampler, pxy, si)
        rgb_f, _, st_f = path_trace_batch(*args, with_stats=True, **kw)
        rgb_g, _, st_g = general_path_trace_batch(*args, **kw)
        assert st_f["fused"] == 1
        assert abs(int(st_f["rays"]) - int(st_g["rays"])) <= max(8, int(st_g["rays"]) // 500)
        assert _frac_off(rgb_f.numpy(), rgb_g.numpy()) < 0.02
        acc = acc + rgb_g.numpy()
    assert _frac_off((acc / 8).reshape(32, 48, 3), ref) < 0.02
