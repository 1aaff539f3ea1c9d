"""The port's image textures, the Nishita sky, ray cones, textured emission
and Loop subdivision (luisarender_tpu_torch/utils/imageio.py,
textures/image.py, textures/sky.py, the compiler's atlas, cameras'
`ray_cone`, the general fork's cone carry, lights/diffuse.py,
shapes/loop_subdiv.py) against the JAX package, on the CPU.

(a) load_image bit for bit against the reference's (which decodes PNG
    through Pillow): PNGs written by save_png, by Pillow in each 8-bit mode,
    and by hand with each scanline filter in each colour type; EXR, PFM,
    Radiance HDR (flat and run-length) and NPY. Every PNG form Pillow's
    convert("RGBA") takes, written by hand (1-, 2-, 4-, 8- and 16-bit grey,
    8- and 16-bit RGB, RGBA and grey-alpha, 1- to 8-bit palettes, each
    plain and Adam7-interlaced, with and without tRNS), decodes byte-equal
    to Pillow's RGBA.
(b) the atlas, its rects and its mip table exactly equal, on images of odd
    sizes, one file used by two textures and a `gamma` copy.
(c) ImageTexture.evaluate_rows on seeded uvs and footprints, every wrap,
    uv scale and offset and both mappings, within 1e-6 (the spherical
    mapping's row within rtol 1e-5 as well: its arccos and atan2).
(d) precompute_sky, each camera's ray_cone and the loopsubdiv mesh equal.
(e) the general fork per sample against the reference's at 16^2, by the
    reference's rule for its fused kernel against its bounce loop
    (tests/test_fused_path.py:108-110: ray counts within 4, under 2% of
    pixels off by more than 1e-3): the textured Cornell box (brute route, a
    textured light, the cone carried), scenes/sky.json at 16 x 9 and depth
    3, and the textured mesh-heavy scene on the cluster route. The
    reference's sample is jitted once a scene (its XLA fallbacks on the
    CPU, not its Pallas kernels).
    The reference's tables, carried across (convert.py), render the port's
    own sample.
(f) an image-textured matte under the hero spectrum: its per-ray decode.
(g) the port's CPU renders against tests/golden/sky_64x36_8spp.exr and
    tests/golden/cornell_textured_48_8spp.exr (the reference's renders), by
    that rule and the mean within 0.5%.
"""

import json
import struct
from types import SimpleNamespace
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import luisarender_tpu as lr
from luisarender_tpu.core.types import Interaction as JInteraction
from luisarender_tpu.integrators.mega_path import path_trace_batch as jax_ptb
from luisarender_tpu.textures.image import ImageTexture as JImage
from luisarender_tpu.utils import imageio as jio
from luisarender_tpu.utils.sky_precompute import precompute_sky as jsky
import luisarender_tpu_torch as lt
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.core.types import Interaction as TInteraction
from luisarender_tpu_torch.integrators.mega_path import path_trace_batch
from luisarender_tpu_torch.textures.image import ImageTexture as TImage
from luisarender_tpu_torch.utils import imageio as tio
from luisarender_tpu_torch.utils.sky_precompute import precompute_sky as tsky

import torch_parity

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"


@pytest.fixture(autouse=True, scope="module")
def _reference_builder():
    """The reference compiles with its native SAH builder, never its Morton
    fallback (tests/torch_parity.py)."""
    torch_parity.require_reference_builder()


def _frac_off(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) > 1e-3).mean())


def _pixels(w, h):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)


# ---------------------------------------------------------------------------
# (a) image loading
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _pack_rows(px, depth):
    """Samples (H, W, C) at `depth` bits -> (H, row bytes) uint8, MSB first."""
    h, w, c = px.shape
    flat = px.reshape(h, w * c).astype(np.int64)
    if depth == 16:
        out = np.zeros((h, w * c * 2), np.uint8)
        out[:, 0::2], out[:, 1::2] = flat >> 8, flat & 0xFF
        return out
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    nb = (w * c + per - 1) // per
    pad = np.zeros((h, nb * per), np.int64)
    pad[:, : w * c] = flat
    shifts = np.asarray([8 - depth * (i + 1) for i in range(per)])
    return (pad.reshape(h, nb, per) << shifts).sum(-1).astype(np.uint8)


def _filter_rows(rows, bpp, filters):
    raw = b""
    prev = np.zeros(rows.shape[1], np.int64)
    for y in range(rows.shape[0]):
        f = filters[y % len(filters)]
        cur = rows[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) >> 1, _paeth(left, prev, upleft)][f]
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    return raw


def _png(path, px, ctype, filters, palette=None, trns=None, depth=8, interlace=0):
    """A PNG written by hand: px (H, W, C) samples at `depth` bits, each row
    filtered with filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3
    Average, 4 Paeth), Adam7's seven passes filtered apart where
    interlace=1."""
    h, w, c = px.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(_filter_rows(_pack_rows(px[y0::dy, x0::dx], depth), bpp, filters)
                       for x0, y0, dx, dy in _ADAM7
                       if px[y0::dy, x0::dx].shape[0] and px[y0::dy, x0::dx].shape[1])
    else:
        raw = _filter_rows(_pack_rows(px, depth), bpp, filters)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        data += chunk(b"tRNS", trns)
    data += chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b"")
    Path(path).write_bytes(data)
    return path


def _noise(h, w, c, seed):
    rs = np.random.default_rng(seed)
    smooth = np.add.outer(np.arange(h) * 7, np.arange(w) * 3)[..., None] + np.arange(c) * 50
    return ((smooth + rs.integers(0, 40, (h, w, c))) % 256).astype(np.uint8)


def _same_load(path):
    got, ref = tio.load_image(path), jio.load_image(path)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_hand_filtered_pngs_load_like_the_reference(tmp_path, filt):
    """Every 8-bit colour type with one scanline filter on every row (and
    all five in turn on the RGB image), decoded bit for bit as Pillow's
    RGBA and then as the reference's linear RGBA."""
    h, w = 13, 11
    palette = _noise(1, 20, 3, seed=9)[0]
    cases = {
        "grey": (0, _noise(h, w, 1, 1), None, None),
        "grey_trns": (0, _noise(h, w, 1, 1), None, struct.pack(">H", int(_noise(h, w, 1, 1)[2, 3, 0]))),
        "rgb": (2, _noise(h, w, 3, 2), None, None),
        "rgb_trns": (2, _noise(h, w, 3, 2), None, struct.pack(">HHH", *_noise(h, w, 3, 2)[0, 0])),
        "palette": (3, (_noise(h, w, 1, 3) % 20).astype(np.uint8), palette,
                    bytes(range(0, 240, 16))),
        "grey_alpha": (4, _noise(h, w, 2, 4), None, None),
        "rgba": (6, _noise(h, w, 4, 5), None, None),
    }
    for name, (ctype, px, pal, trns) in cases.items():
        filters = [filt] if name != "rgb" or filt else [0, 1, 2, 3, 4]
        path = _png(tmp_path / f"{name}.png", px, ctype, filters, pal, trns)
        np.testing.assert_array_equal(tio.png_rgba8(path),
                                      np.asarray(Image.open(path).convert("RGBA")), name)
        _same_load(path)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_pillow_pngs_load_like_the_reference(tmp_path, mode):
    """Pillow's own PNG writer (its adaptive filters) in each 8-bit mode;
    the palette image with a transparent entry."""
    px = _noise(37, 29, 4, seed=len(mode))
    img = Image.fromarray(px, "RGBA").convert(mode)
    kw = {"transparency": 3} if mode == "P" else {}
    img.save(tmp_path / "p.png", **kw)
    with open(tmp_path / "p.png", "rb") as f:
        body = f.read()
    # Pillow filtered the rows: more than one filter type appears
    raw = zlib.decompress(b"".join(
        body[i + 8:i + 8 + struct.unpack(">I", body[i:i + 4])[0]]
        for i in range(8, len(body)) if body[i + 4:i + 8] == b"IDAT"))
    stride = len(raw) // 37
    assert mode == "P" or len({raw[y * stride] for y in range(37)}) > 1
    _same_load(tmp_path / "p.png")


def test_save_png_files_and_refusals(tmp_path):
    """save_png's files, and the two forms the port's decoder once refused
    (a 16-bit and an interlaced PNG), load like the reference's."""
    rs = np.random.default_rng(4)
    for c in (1, 3, 4):
        tio.save_png(tmp_path / f"s{c}.png", rs.uniform(0, 1, (9, 14, c)).astype(np.float32))
        out = _same_load(tmp_path / f"s{c}.png")
        assert out.shape == (9, 14, 4)
    px = _noise(4, 4, 3, seed=1)
    _same_load(_png(tmp_path / "i.png", px, 2, [0], interlace=1))
    raw16 = px.astype(np.int64) * 257 + np.arange(3)
    _same_load(_png(tmp_path / "d.png", raw16, 2, [0], depth=16))


# (colour type, bit depth) of every form; grey and palette at every depth
PNG_FORMS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
             (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _form_case(ctype, depth, trns, seed):
    """Samples of a 13 x 11 image at the form's depth (16-bit grey partly
    below 256, where Pillow's clamp leaves it), its palette and a tRNS
    chunk: a palette's alphas, or the colour key of the first pixel."""
    rs = np.random.default_rng(seed)
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    px = rs.integers(0, 1 << depth, (13, 11, c))
    if ctype == 0 and depth == 16:
        px[::2] = rs.integers(0, 300, px[::2].shape)
    palette = rs.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    key = None
    if trns and ctype == 3:
        key = bytes(rs.integers(0, 256, min(5, 1 << depth)).astype(np.uint8))
    elif trns:
        key = struct.pack(">" + "H" * c, *(int(v) for v in px[0, 0]))
    return px, palette, key


# every form plain and interlaced, with a tRNS chunk where the form allows one
PNG_CASES = [(c, d, i, t) for c, d in PNG_FORMS for i in (0, 1)
             for t in ((False,) if c in (4, 6) else (False, True))]


@pytest.mark.parametrize("ctype,depth,interlace,trns", PNG_CASES,
                         ids=[f"type{c}_{d}bit{'_adam7' if i else ''}{'_trns' if t else ''}"
                              for c, d, i, t in PNG_CASES])
def test_png_forms_load_like_pillow(tmp_path, ctype, depth, interlace, trns):
    """Every PNG form, rows filtered with all five filters in turn: the
    port's RGBA byte-equal to Pillow's convert("RGBA"), and load_image to
    the reference's. Pillow's rules, not the specification's: 16-bit grey
    clamps to 255, the other 16-bit types keep their high byte, a 2- or
    4-bit grey key never matches its scaled grey."""
    px, palette, key = _form_case(ctype, depth, trns, seed=10 * ctype + depth)
    path = _png(tmp_path / "f.png", px, ctype, [0, 1, 2, 3, 4], palette=palette,
                trns=key, depth=depth, interlace=interlace)
    ref = np.asarray(Image.open(path).convert("RGBA"))
    got = tio.png_rgba8(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (13, 11, 4)
    np.testing.assert_array_equal(got, ref)
    _same_load(path)


def test_png_sixteen_bit_traps():
    """The two 16-bit traps on exact values: grey 0, 255, 256, 1000, 65535
    -> 0, 255, 255, 255, 255 (clamped); RGB 256, 1000, 65535 -> 1, 3, 255
    (the high byte)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        grey = np.asarray([0, 255, 256, 1000, 65535]).reshape(1, 5, 1)
        got = tio.png_rgba8(_png(Path(d) / "g.png", grey, 0, [0], depth=16))
        np.testing.assert_array_equal(got[0, :, 0], [0, 255, 255, 255, 255])
        rgb = np.repeat(np.asarray([256, 1000, 65535]).reshape(1, 3, 1), 3, axis=-1)
        got = tio.png_rgba8(_png(Path(d) / "c.png", rgb, 2, [0], depth=16))
        np.testing.assert_array_equal(got[0, :, 0], [1, 3, 255])


def _hdr_bytes(rgbe, rle):
    h, w = rgbe.shape[:2]
    out = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        if not rle:
            out += rgbe[y].tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            line = rgbe[y, :, c]
            # a run of the first 5 bytes, then literals of at most 128
            out += bytes([128 + 5, int(line[0])])
            x = 5
            while x < w:
                n = min(128, w - x)
                out += bytes([n]) + line[x:x + n].tobytes()
                x += n
    return out


@pytest.mark.parametrize("fmt", ["exr", "pfm", "hdr_flat", "hdr_rle", "npy"])
def test_float_images_load_like_the_reference(tmp_path, fmt):
    rs = np.random.default_rng(6)
    img = rs.uniform(0.0, 4.0, (7, 19, 3)).astype(np.float32)
    if fmt == "exr":
        path = tmp_path / "f.exr"
        tio.save_exr(path, img)
    elif fmt == "pfm":
        path = tmp_path / "f.pfm"
        tio.save_pfm(path, img)
    elif fmt == "npy":
        path = tmp_path / "f.npy"
        np.save(path, img[..., :2].astype(np.float64))
    else:
        rgbe = rs.integers(0, 256, (7, 19, 4)).astype(np.uint8)
        rgbe[..., 3] = rs.integers(120, 140, (7, 19))
        rgbe[0, 0, 3] = 0
        rgbe[:, :5] = rgbe[:, :1]  # the run-length run
        path = tmp_path / "f.hdr"
        path.write_bytes(_hdr_bytes(rgbe, fmt == "hdr_rle"))
    _same_load(path)


# ---------------------------------------------------------------------------
# (b) the atlas, (c) evaluate_rows
# ---------------------------------------------------------------------------


def _image(file, **prop):
    return {"impl": "image", "prop": {"file": str(file), **prop}}


@pytest.fixture(scope="module")
def atlas_scenes(tmp_path_factory):
    """The Cornell box with image textures on seven surfaces: an odd-sized
    RGB PNG on three of them (two textures of one file, and a gamma copy),
    a grey PNG, a palette PNG, an EXR and a PFM, with every wrap, uv scale
    and offset, and a uv and a spherical mapping node; compiled by both."""
    tmp = tmp_path_factory.mktemp("atlas")
    rgb = _png(tmp / "rgb.png", _noise(37, 23, 3, 11), 2, [0, 1, 2, 3, 4])
    grey = _png(tmp / "grey.png", _noise(5, 9, 1, 12), 0, [4])
    pal = _png(tmp / "pal.png", (_noise(6, 30, 1, 13) % 8).astype(np.uint8), 3, [1],
               palette=_noise(1, 8, 3, 14)[0])
    rs = np.random.default_rng(15)
    tio.save_exr(tmp / "map.exr", rs.uniform(0.0, 3.0, (16, 9, 3)).astype(np.float32))
    tio.save_pfm(tmp / "map.pfm", rs.uniform(0.0, 2.0, (12, 20, 3)).astype(np.float32))
    uv_map = {"impl": "uv", "prop": {"uv_scale": [1.5, 0.5], "uv_offset": [0.2, 0.1]}}
    sph_map = {"impl": "spherical", "prop": {"uv_scale": [2.0, 1.0], "uv_offset": [0.0, 0.3]}}
    textures = [
        _image(rgb, uv_scale=[3.0, 2.0], uv_offset=[0.1, -0.2]),
        _image(rgb, wrap="clamp", scale=[0.5, 1.0, 2.0]),
        _image(rgb, encoding="gamma", gamma=1.8, wrap="mirror", uv_scale=[-2.0, 1.0]),
        _image(tmp / "map.exr", mapping=sph_map),
        _image(grey, mapping=uv_map, wrap="mirror"),
        _image(tmp / "map.pfm", wrap="clamp", uv_offset=[0.5, 0.5]),
        _image(pal, uv_scale=[4.0, 4.0]),
    ]
    d = testing.cornell_box(resolution=(8, 8), spp=1, depth=2)
    for shape, tex in zip(d["render"]["shapes"], textures):
        shape["prop"]["surface"] = {"impl": "matte", "prop": {"Kd": tex}}
    jscene = lr.Scene.from_dict(d)
    tscene = lt.Scene.from_dict(d)
    return jscene, lr.compile_scene(jscene), tscene, lt.compile_scene(tscene, device="cpu")


def test_atlas_tables_equal_the_reference(atlas_scenes):
    jscene, jcomp, tscene, tcomp = atlas_scenes
    for key in ("texture_atlas", "texture_atlas_rects", "texture_atlas_mips"):
        got, ref = tcomp.arrays[key].numpy(), np.asarray(jcomp.arrays[key])
        assert got.dtype == ref.dtype and got.shape == ref.shape, key
        np.testing.assert_array_equal(got, ref, key)
    mips = tcomp.arrays["texture_atlas_mips"].numpy()
    # one file twice is one entry; its gamma copy, the grey, palette, EXR
    # and PFM images are five more; 37 x 23 halves to 1 x 1 in 7 levels
    assert mips.shape[0] == 6 and mips[0, 1] == 7
    assert tcomp.arrays["texture_atlas"].shape[1] == 2048
    ref_rows = jcomp.arrays["textures"]["image"]
    for k, v in tcomp.arrays["textures"]["image"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_rows[k]), k)
    assert tcomp.plan.needs_footprint and not tcomp.plan.fused_path


def _interactions(n, seed, footprint):
    rs = np.random.default_rng(seed)
    p = rs.normal(0.0, 3.0, (n, 3)).astype(np.float32)
    uv = rs.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    foot = (10.0 ** rs.uniform(-4.0, 0.5, n)).astype(np.float32) if footprint else None
    zeros = np.zeros((n, 3), np.float32)
    j = JInteraction(valid=jnp.ones(n, bool), inst=jnp.zeros(n, jnp.int32),
                     prim=jnp.zeros(n, jnp.int32), p=jnp.asarray(p), ng=jnp.asarray(zeros),
                     ns=jnp.asarray(zeros), tangent=jnp.asarray(zeros), uv=jnp.asarray(uv),
                     prim_area=jnp.ones(n), back_facing=jnp.zeros(n, bool),
                     footprint=None if foot is None else jnp.asarray(foot))
    t = TInteraction(valid=torch.ones(n, dtype=torch.bool), inst=torch.zeros(n, dtype=torch.int32),
                     prim=torch.zeros(n, dtype=torch.int32), p=torch.as_tensor(p),
                     ng=torch.as_tensor(zeros), ns=torch.as_tensor(zeros),
                     tangent=torch.as_tensor(zeros), uv=torch.as_tensor(uv),
                     prim_area=torch.ones(n), back_facing=torch.zeros(n, dtype=torch.bool),
                     footprint=None if foot is None else torch.as_tensor(foot))
    return j, t


def _ref_rows(arrays, index, it):
    """The reference's evaluate_rows (it reads only ctx.arrays), op by op:
    under jax.jit XLA contracts uv * scale + offset into one rounding, and
    the texel weights move by up to 2e-5."""
    return JImage.evaluate_rows(SimpleNamespace(arrays=arrays), index, it)


@pytest.mark.parametrize("footprint", [False, True], ids=["base_level", "ray_cone_lod"])
def test_evaluate_rows_match_the_reference(atlas_scenes, footprint):
    jscene, jcomp, tscene, tcomp = atlas_scenes
    n = 8192
    jit, tit = _interactions(n, seed=21, footprint=footprint)
    rows = tcomp.arrays["textures"]["image"]["image_id"].shape[0]
    index = np.random.default_rng(22).integers(0, rows, n).astype(np.int32)
    ref = np.asarray(_ref_rows(jcomp.arrays, jnp.asarray(index), jit))
    got = TImage.evaluate_rows(tcomp, torch.as_tensor(index), tit).numpy()
    # the spherical mapping's arccos and atan2 round differently by an ulp
    # in XLA and PyTorch, and its map's texels differ by up to ~100x that
    # over a unit of u: its row is held within rtol 1e-5 as well, as
    # tests/test_torch_textures.py holds the mapping
    sph = (tcomp.arrays["textures"]["image"]["mapping_type"].numpy() == 1)[index]
    assert 0 < sph.sum() < n
    np.testing.assert_allclose(got[~sph], ref[~sph], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[sph], ref[sph], rtol=1e-5, atol=1e-6)
    # every row varies over its lanes, and the footprints pick several levels
    for r in range(rows):
        assert np.ptp(got[index == r, 0]) > 0.0, r


# ---------------------------------------------------------------------------
# (d) the sky, ray cones, loopsubdiv
# ---------------------------------------------------------------------------


def test_sky_cones_and_loopsubdiv_equal_the_reference():
    kw = dict(resolution=(32, 64), sun_direction=(0.4, 0.35, 0.85), sun_intensity=20.0,
              altitude=100.0)
    np.testing.assert_array_equal(tsky(**kw), jsky(**kw))
    with open(ROOT / "scenes" / "sky.json") as f:
        sky = json.load(f)
    cams = {
        "thinlens": sky["render"]["cameras"][0],
        "pinhole": testing.cornell_box()["render"]["cameras"][0],
        "ortho": {"impl": "ortho", "prop": {"zoom": 1.5, "film": {"impl": "color", "prop": {
            "resolution": [40, 30]}}}},
        "thinlens_portrait": {"impl": "thinlens", "prop": {"focal_length": 50.0, "film": {
            "impl": "color", "prop": {"resolution": [30, 40]}}}},
    }
    for name, cam in cams.items():
        d = {**sky, "render": {**sky["render"], "cameras": [cam]}}
        got = lt.Scene.from_dict(d).cameras[0].ray_cone()
        assert got == lr.Scene.from_dict(d).cameras[0].ray_cone(), name
        assert got[0] > 0.0 if name == "ortho" else got[1] > 0.0, name
    jmesh = lr.Scene.from_dict(sky).shapes[2].mesh()
    tmesh = lt.Scene.from_dict(sky).shapes[2].mesh()
    assert tmesh.triangles.shape == (256, 3) and tmesh.uvs is None is jmesh.uvs
    for k in ("positions", "triangles", "normals"):
        np.testing.assert_array_equal(getattr(tmesh, k), getattr(jmesh, k), k)


# ---------------------------------------------------------------------------
# (e) the general fork per sample, (f) hero
# ---------------------------------------------------------------------------


def _against_reference(d, spp, depth, route):
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    assert not tcomp.plan.fused_path and not jcomp.plan.fused_path
    assert ("cluster_nodes" in tcomp.arrays["trace"]) == (route == "cluster")
    w, h = tscene.cameras[0].film.resolution
    pxy = _pixels(w, h)
    kw = dict(max_depth=depth, rr_depth=0, rr_threshold=0.95)
    ref_sample = jax.jit(lambda arrays, si: jax_ptb(
        jcomp, arrays, jscene.cameras[0], jscene.integrator.sampler,
        jscene.integrator.light_sampler, jnp.asarray(pxy), si, with_stats=True, **kw))
    for si in range(spp):
        rgb_ref, _, st_ref = ref_sample(jcomp.arrays, jnp.int32(si))
        rgb, _, st = path_trace_batch(
            tcomp, tscene.cameras[0], tscene.integrator.sampler,
            tscene.integrator.light_sampler, torch.as_tensor(pxy), si, with_stats=True, **kw)
        assert st["fused"] == 0 and st["bounces"] >= 1
        assert abs(int(st["rays"]) - int(st_ref["rays"])) <= 4, (si, st["rays"], st_ref["rays"])
        rgb = rgb.numpy()
        assert np.isfinite(rgb).all() and rgb.shape == (w * h, 3) and rgb.mean() > 0.0
        assert _frac_off(rgb, np.asarray(rgb_ref)) < 0.02, si
    return tcomp


def _sky_dict(res, spp, depth=None):
    with open(ROOT / "scenes" / "sky.json") as f:
        d = json.load(f)
    cam = d["render"]["cameras"][0]["prop"]
    cam["film"]["prop"]["resolution"] = list(res)
    cam["spp"] = spp
    if depth is not None:
        d["render"]["integrator"]["prop"]["depth"] = depth
    return d


def test_textured_cornell_matches_the_reference(monkeypatch):
    """A textured back wall and a textured light on the brute route: the
    cone is carried, NEE samples read the light's base level and BSDF hits
    on it its ray-cone level."""
    from luisarender_tpu_torch.lights.diffuse import DiffuseLight

    feet = []
    orig = DiffuseLight._radiance

    def radiance(params, ctx, it_light, swl):
        feet.append(None if it_light is None else it_light.footprint)
        return orig(params, ctx, it_light, swl)

    monkeypatch.setattr(DiffuseLight, "_radiance", staticmethod(radiance))
    tcomp = _against_reference(testing.cornell_textured(resolution=(16, 16)), 2, 5, "brute")
    assert tcomp.plan.needs_footprint and "emission__h" in tcomp.arrays["lights"][0]
    assert any(f is None for f in feet) and any(f is not None for f in feet)


def test_sky_scene_matches_the_reference():
    """scenes/sky.json: the Nishita sky through the spherical map's alias
    tables, the thin lens, the Loop-subdivided glass tetrahedron (256
    triangles), a rough copper sphere; no image on a surface, so no cone."""
    tcomp = _against_reference(_sky_dict((16, 9), 2, depth=3), 2, 3, "brute")
    assert tcomp.plan.num_tris == 258 and tcomp.plan.has_environment
    assert not tcomp.plan.needs_footprint and not tcomp.scene.environment.constant
    assert tuple(tcomp.arrays["texture_atlas"].shape) == (1, 1, 4)


def test_textured_mesh_heavy_matches_the_reference():
    d = testing.mesh_heavy(res=(16, 16), spp=2, depth=3, n=2, subdiv=2, textured=True)
    tcomp = _against_reference(d, 2, 3, "cluster")
    assert tcomp.plan.needs_footprint
    assert tcomp.arrays["texture_atlas_mips"].tolist() == [[0, 9]]


def test_converted_textured_scene_renders_like_the_port():
    """The reference's tables of the textured Cornell box carried across
    (convert.py: the atlas, the image rows, the wall's and the light's
    texture handles) render the port's own sample bit for bit."""
    from luisarender_tpu_torch import convert

    d = testing.cornell_textured(resolution=(16, 16), spp=1, depth=4)
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    conv = convert.convert(
        jax.device_get(jcomp.arrays), [c.impl_names[0] for c in jcomp.plan.surface_types],
        [c.impl_names[0] for c in jcomp.plan.light_types], tscene, device="cpu",
        bvh_leaf_size=jcomp.plan.bvh_leaf_size,
        texture_types=[c.impl_names[0] for c in jcomp.plan.texture_types])
    assert conv.plan.needs_footprint and "emission__h" in conv.arrays["lights"][0]
    for key in convert.ATLAS_KEYS:
        assert torch.equal(conv.arrays[key], tcomp.arrays[key]), key
    integ = tscene.integrator
    kw = dict(max_depth=4, rr_depth=0, rr_threshold=0.95)
    rgb_conv, rgb_own = (
        path_trace_batch(comp, tscene.cameras[0], integ.sampler, integ.light_sampler,
                         torch.as_tensor(_pixels(16, 16)), 1, **kw)[0]
        for comp in (conv, tcomp))
    assert torch.equal(rgb_conv, rgb_own)


def test_image_textured_matte_under_hero():
    """Under hero the textured back wall's albedo decodes per ray
    (spectral_param's `__h` lanes) at seeded interactions, footprints
    included, as the reference decodes an evaluated texture (its
    spectral_param: the hero model's decode_albedo of evaluate_rows); the
    port's hero render of the scene stays finite."""
    from luisarender_tpu_torch.textures.base import HANDLE_INDEX_MASK, evaluate_tex_params
    from luisarender_tpu_torch.textures.base import spectral_param

    d = testing.cornell_textured(resolution=(8, 8), spp=1, depth=3)
    d["render"]["spectrum"] = {"impl": "hero", "prop": {"dimension": 4}}
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    inst = tcomp.arrays["instances"]
    tag, idx = int(inst["surface_tag"][2]), int(inst["surface_index"][2])
    table = tcomp.arrays["surfaces"][tag]
    handle = int(table["kd__h"][idx])
    assert "kd__ca" in table and handle >= 0
    n = 8192
    jit, tit = _interactions(n, seed=31, footprint=True)
    u = np.random.default_rng(32).uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    swl = tcomp.spectrum.sample_wavelengths(torch.as_tensor(u))
    rows = {k: v[torch.full((n,), idx)] for k, v in table.items()}
    rows = evaluate_tex_params(tcomp, rows, tit, type(tscene.shapes[2].surface).texture_params)
    got = spectral_param(tcomp, rows, "kd", swl, "albedo").numpy()
    rgba = _ref_rows(jcomp.arrays, jnp.full((n,), handle & HANDLE_INDEX_MASK, jnp.int32), jit)
    ref = np.asarray(jcomp.spectrum.decode_albedo(
        rgba[..., :3], jcomp.spectrum.sample_wavelengths(jnp.asarray(u))))
    assert got.shape == (n, 4) and np.ptp(got) > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    img = lt.render(tscene, device="cpu")["cornell.exr"]
    assert np.isfinite(img).all() and img.mean() > 0.0


# ---------------------------------------------------------------------------
# (g) the goldens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sky_64x36_8spp", "cornell_textured_48_8spp"])
def test_cpu_render_matches_the_golden(name):
    if name.startswith("sky"):
        scene = lt.Scene.from_dict(_sky_dict((64, 36), 8))
    else:
        scene = lt.Scene.from_dict(testing.cornell_textured(resolution=(48, 48), spp=8))
    img = next(iter(lt.render(scene, device="cpu").values()))
    ref = jio.load_exr(str(GOLDEN / f"{name}.exr"))
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert scene.integrator.fused_passes == 0
    assert _frac_off(img, ref) < 0.02
    assert abs(float(img.mean() / ref.mean()) - 1.0) < 0.005

