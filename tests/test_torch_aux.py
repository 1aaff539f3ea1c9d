"""The port's auxiliary integrators (luisarender_tpu_torch/integrators/
aux.py: normal, direct, aov, group) against the JAX package's on the
Cornell box at 16^2, on the CPU: each render of both packages gives the
same files, and each image equals the reference's within 1e-5 relative
(the depth buffer within 1e-6 relative: its values are ~1,000):

(a) normal: shading and remapped, geometric and raw;
(b) direct: importance_sampling light, surface and both, 4 spp;
(c) aov's legacy variants (mask, depth, albedo, roughness, normal and
    sample, which renders megapath's sample: on the port's fused fork and
    the reference's general fork, so by the goldens' rule) into the
    camera's film;
(d) aov's multi-buffer mode: all nine components dumped at powers of two
    (1, 2, 4: 27 images named `{stem}_{component}_{count:05}{ext}`), a
    `final` dump (`{stem}_{component}{ext}`) and an `all` dump, and with
    save=True every component's file written with the image in it;
(e) group: normal and direct one after the other, their images the
    integrators' own.
"""

import numpy as np
import pytest

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.utils import imageio

import torch_parity


@pytest.fixture(autouse=True, scope="module")
def _reference_builder():
    torch_parity.require_reference_builder()


def _cornell(integrator, res=16, spp=2, **props):
    d = testing.cornell_box(resolution=(res, res), spp=spp, depth=3)
    d["render"]["integrator"] = {"impl": integrator, "prop": props}
    return d


def _both(d, rule=False):
    """Both packages' renders of d, each image within 1e-5 relative or, with
    rule=True, by the goldens' rule (under 2% of pixels off by more than
    1e-3, the mean within 0.5%)."""
    ref = lr.render(lr.Scene.from_dict(d))
    scene = lt.Scene.from_dict(d)
    got = lt.render(scene, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        want = np.asarray(ref[k])
        assert got[k].shape == want.shape and np.isfinite(got[k]).all(), k
        if rule:
            assert (np.abs(got[k] - want).max(-1) > 1e-3).mean() < 0.02, k
            assert abs(got[k].mean() / want.mean() - 1.0) < 0.005, k
        else:
            np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-6, err_msg=k)
    return got, scene


@pytest.mark.parametrize("props", [{}, {"normal": "geometric", "remap": False}],
                         ids=["shading_remapped", "geometric_raw"])
def test_normal_matches_reference(props):
    got, _ = _both(_cornell("normal", **props))
    img = got["cornell.exr"]
    assert img.min() >= 0.0 and img.max() <= 1.0 + 1e-6
    if props:
        # raw normals: the film keeps no negative radiance, so the back
        # wall's (0, 0, -1) is black
        assert img[8, 8].max() < 1e-6


@pytest.mark.parametrize("mode", ["light", "surface", "both"])
def test_direct_matches_reference(mode):
    got, _ = _both(_cornell("direct", spp=4, importance_sampling=mode))
    assert got["cornell.exr"].mean() > 0.01


@pytest.mark.parametrize("variant", ["mask", "depth", "albedo", "roughness", "normal",
                                     "sample"])
def test_aov_variant_matches_reference(variant):
    # `sample` is megapath's sample, on the port's fused fork here and the
    # reference's general fork
    got, _ = _both(_cornell("aov", variant=variant), rule=variant == "sample")
    img = got["cornell.exr"]
    if variant == "depth":
        # the film's clamp is lifted: the buffer is data
        assert img.max() > 256.0


def test_aov_power2_dump_matches_reference():
    got, _ = _both(_cornell("aov", noisy_count=4, dump="power2"))
    names = {f"cornell_{c}_{n:05d}.exr" for c in lt.Scene.from_dict(
        _cornell("aov")).integrator.COMPONENTS for n in (1, 2, 4)}
    assert set(got) == names and len(names) == 27
    assert got["cornell_depth_00004.exr"].shape == (16, 16, 1)
    assert got["cornell_roughness_00002.exr"].shape == (16, 16, 2)
    # the box is all matte: everything is diffuse
    np.testing.assert_allclose(got["cornell_diffuse_00004.exr"],
                               got["cornell_sample_00004.exr"], rtol=1e-5)


@pytest.mark.parametrize("dump", ["final", "all"])
def test_aov_dump_names(dump, tmp_path, monkeypatch):
    d = _cornell("aov", noisy_count=2, dump=dump, components=["albedo", "roughness", "ndc"])
    got, scene = _both(d)
    counts = ("",) if dump == "final" else ("_00001", "_00002")
    assert set(got) == {f"cornell_{c}{n}.exr" for c in ("albedo", "ndc", "roughness")
                        for n in counts}
    monkeypatch.chdir(tmp_path)
    saved = scene.integrator.render(lt.compile_scene(scene, device="cpu"), save=True)
    for path, img in saved.items():
        np.testing.assert_array_equal(imageio.load_exr(str(tmp_path / path)), img)


def test_group_runs_its_children():
    d = testing.cornell_box(resolution=(16, 16), spp=2, depth=2)
    d["render"]["integrator"] = {"impl": "group", "prop": {"integrators": [
        {"impl": "normal", "prop": {}}, {"impl": "direct", "prop": {}}]}}
    scene = lt.Scene.from_dict(d)
    got = lt.render(scene, device="cpu")
    assert [type(c).__name__ for c in scene.integrator.children] == [
        "NormalVisualizer", "DirectLighting"]
    # both children write the camera's file; the last one's image stays
    direct = lt.render(lt.Scene.from_dict(_cornell("direct", spp=2)), device="cpu")
    np.testing.assert_array_equal(got["cornell.exr"], direct["cornell.exr"])
    ref = lr.render(lr.Scene.from_dict(d))
    np.testing.assert_allclose(got["cornell.exr"], np.asarray(ref["cornell.exr"]),
                               rtol=1e-5, atol=1e-6)
