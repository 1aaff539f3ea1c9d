"""The port's display film (luisarender_tpu_torch/films/display.py), its
live viewer (films/live_server.py), the colour functions they use
(core/colorspace.py) and the progressive loop's per-pass hook:

(a) srgb_encode, srgb_decode and the three tone maps against the
    reference's (rtol 1e-6);
(b) a render with the display film writes its preview: an sRGB PNG, or a
    linear EXR with `hdr`; the loop hands the film every pass;
(c) with `serve: true` and port 0 the viewer answers /, /frame.png and
    /stats.json on 127.0.0.1, and binds nothing else;
(d) an unknown tone map raises ValueError, as in the reference.
"""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisarender_tpu.core import colorspace as jcs
import luisarender_tpu_torch as lt
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.core import colorspace as tcs
from luisarender_tpu_torch.utils import imageio

TONEMAPS = ("none", "uncharted2", "aces")


def _values():
    rs = np.random.RandomState(2)
    x = (rs.rand(4096, 3) * 4.0).astype(np.float32) ** 3
    x[:8, 0] = (0.0, 1e-12, 0.0031308, 0.003131, 0.04045, 0.0405, 1.0, 30.0)
    x[8:12, 1] = (-1.0, -1e-6, 1e-10, 5.0)
    return x


@pytest.mark.parametrize("fn", ["srgb_encode", "srgb_decode"])
def test_srgb_curves_match_reference(fn):
    x = _values()
    got = getattr(tcs, fn)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jcs, fn)(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("name", TONEMAPS)
def test_tonemaps_match_reference(name):
    x = _values()
    got = tcs.TONEMAP_OPERATORS[name](torch.as_tensor(x)).numpy()
    want = np.asarray(jcs.TONEMAP_OPERATORS[name](jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _scene(tmp_path, extra, spp=4):
    d = testing.cornell_box(resolution=(16, 16), spp=spp, depth=2)
    d["render"]["integrator"]["prop"]["samples_per_pass"] = 2
    cam = d["render"]["cameras"][0]["prop"]
    cam["film"] = {"impl": "display", "prop": {
        "resolution": [16, 16], "tone_mapping": "aces",
        "preview_file": str(tmp_path / ("preview.exr" if extra.get("hdr") else "preview.png")),
        "target_fps": 1000.0,  # every pass
        **extra}}
    return lt.Scene.from_dict(d)


@pytest.mark.parametrize("hdr", [False, True])
def test_preview_written(tmp_path, hdr):
    scene = _scene(tmp_path, {"hdr": hdr}, spp=6)
    img = lt.render(scene, device="cpu")["cornell.exr"]
    assert np.isfinite(img).all() and img.mean() > 0
    film = scene.cameras[0].film
    assert film._server is None and film._spp_seen == 3  # passes of 2 samples
    if hdr:
        preview = imageio.load_exr(str(tmp_path / "preview.exr"))
        # the last pass's preview: the aces map of the final image
        want = tcs.tonemap_aces(torch.as_tensor(img)).numpy()
        np.testing.assert_allclose(preview, want, rtol=1e-6, atol=1e-7)
    else:
        assert (tmp_path / "preview.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        rgba = imageio.png_rgba8(str(tmp_path / "preview.png"))
        assert rgba.shape == (16, 16, 4) and rgba[..., :3].max() > 0


def test_live_server_serves_frames(tmp_path):
    scene = _scene(tmp_path, {"serve": True, "port": 0})
    film = scene.cameras[0].film
    try:
        assert film._server._httpd.server_address[0] == "127.0.0.1"
        port = film._server.port
        lt.render(scene, device="cpu")

        def get(path):
            return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10).read()

        assert b"luisarender_tpu live" in get("/")
        assert get("/frame.png")[:8] == b"\x89PNG\r\n\x1a\n"
        stats = json.loads(get("/stats.json"))
        assert stats["frame"] >= 1 and stats["spp"] >= 1 and stats["elapsed"] >= 0
    finally:
        film._server.close()


def test_unknown_tone_map_raises(tmp_path):
    with pytest.raises(ValueError, match="tone mapping"):
        _scene(tmp_path, {"tone_mapping": "filmic"})
