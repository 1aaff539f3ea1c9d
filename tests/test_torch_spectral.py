"""The hero-wavelength spectrum in the port (core/cie.py, core/colorspace.py,
core/rgb2spec.py, core/spectrum.py, spectra/hero.py, the compiler's and
convert.py's coefficient columns, textures/base.py spectral_param, the
dispersion step of integrators/common.py and the wavelength draw of
integrators/mega_path.py) against the reference, on the CPU, on the same
numpy-seeded inputs. In one file, so that one worker builds the
coefficient tables.

(a) the constants (CIE_Y_INTEGRAL, _ILLUM_NORM, SRGB_FROM_XYZ and the fit's
    basis), fit_rgb and the tables lut(8) and lut(24) equal the
    reference's: the same numpy float64 code runs on both sides;
(b) the CIE fits, d65, sample_visible, visible_pdf and sample_wavelengths
    (dimensions 1, 4, 8, u near 0 and 1) within rtol 2e-6 (torch's and
    XLA's exp, atanh and cosh differ in the last bits; the fits also within
    atol 1e-8, where cie_x's lobes cancel);
(c) _coeffs and the three decodes on rgb in and out of [0, 1] (greys,
    whose channels tie, and the emission [17, 12, 4]) within atol 1e-5,
    and the coefficient route equal to the per-ray route bit for bit;
(d) spectral_to_xyz / srgb and terminate_secondary / dispersive_mask;
(e) the general fork, per sample, against the reference's
    path_trace_batch on the same pixels by the repo's rule (ray counts
    within 4, under 2% of pixels off by more than 1e-3):
    scenes/cornell_spectral.json with a bk7 glass sphere added
    (dispersion) and its tall block plastic with sigma_a past 1 (the
    unbounded decode); a small mesh-heavy scene, its Disney spheres matte
    (the checkerboard's per-ray decode, the environment, the cluster
    route). The reference compiles one sample of each scene, 10-35 s on a
    CPU, so the scene file alone is held by (f) and not compiled again;
(f) the port's 48^2, 8-spp render of scenes/cornell_spectral.json against
    tests/golden/cornell_spectral_48_8spp.exr, the reference's render of
    it; a converted hero scene renders the port's own image;
(g) the refusals: Disney under hero (NotImplementedError, the reference's
    fault at luisarender_tpu/surfaces/disney.py:344), hero dimension 0 or
    9 (ValueError), a hero scene on the fused fork (RuntimeError).
"""

import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu.core import cie as jcie
from luisarender_tpu.core import colorspace as jcs
from luisarender_tpu.core import rgb2spec as jr2s
from luisarender_tpu.core import spectrum as jspec
from luisarender_tpu.integrators.mega_path import path_trace_batch as jax_ptb
from luisarender_tpu.spectra import hero as jhero
from luisarender_tpu.surfaces import base as jsurf
from luisarender_tpu.utils import imageio as jimageio
from luisarender_tpu_torch import convert, testing
from luisarender_tpu_torch.core import cie, colorspace, rgb2spec, spectrum
from luisarender_tpu_torch.integrators.mega_path import path_trace_batch
from luisarender_tpu_torch.ops import build
from luisarender_tpu_torch.spectra import hero
from luisarender_tpu_torch.surfaces import base as surf_base

from torch_parity import require_reference_builder

ROOT = Path(__file__).resolve().parent.parent
SPECTRAL_SCENE = ROOT / "scenes" / "cornell_spectral.json"
GOLDEN = ROOT / "tests" / "golden" / "cornell_spectral_48_8spp.exr"
RTOL = 2e-6


def _frac_off(a, b):
    return float((np.abs(a - b).max(-1) > 1e-3).mean())


def _pixels(w, h):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)


def _spectral_cornell(res, spp, depth):
    with open(SPECTRAL_SCENE) as f:
        d = json.load(f)
    cam = d["render"]["cameras"][0]["prop"]
    cam["film"]["prop"]["resolution"] = [res, res]
    cam["spp"] = spp
    d["render"]["integrator"]["prop"]["depth"] = depth
    return d


def _plastic(kd, sigma_a):
    return {"impl": "plastic", "prop": {
        "Kd": {"impl": "constant", "prop": {"v": kd}},
        "sigma_a": {"impl": "constant", "prop": {"v": sigma_a}},
        "roughness": {"impl": "constant", "prop": {"v": [0.2]}}}}


def _dispersive_cornell(res, spp, depth):
    """scenes/cornell_spectral.json, its tall block plastic with sigma_a
    [2, 0.5, 0.1] (scale 4 in the unbounded fit), a bk7 glass icosphere
    over the short block: 352 triangles, matte, plastic and glass."""
    d = _spectral_cornell(res, spp, depth)
    d["render"]["shapes"][6]["prop"]["surface"] = _plastic([0.6, 0.5, 0.3], [2.0, 0.5, 0.1])
    d["render"]["shapes"].append({"impl": "sphere", "prop": {
        "analytic": False, "subdivision": 2,
        "surface": {"impl": "glass", "prop": {"material": "bk7"}},
        "transform": {"impl": "srt", "prop": {"scale": [80, 80, 80],
                                              "translate": [186, 250, 168]}}}})
    return d


def _small_heavy():
    """testing.mesh_heavy at 16 x 9, 2 x 2 spheres of subdivision 2 (1,284
    triangles: the cluster route), under hero, its Disney spheres matte of
    the same colour: one surface type, so that the reference's sample
    compiles in ~11 s (plastic ones, as chip_smoke.py renders the full
    scene, ~20 s; the plastic decode is held by the dispersive case)."""
    d = testing.mesh_heavy(res=(16, 9), spp=2, depth=3, n=2, subdiv=2)
    for s in d["render"]["shapes"]:
        surf = s["prop"]["surface"]
        if surf["impl"] == "disney":
            s["prop"]["surface"] = {"impl": "matte", "prop": {"Kd": surf["prop"]["color"]}}
    return testing.hero(d)


def _compile_both(d):
    require_reference_builder()
    jscene = lr.Scene.from_dict(d)
    tscene = lt.Scene.from_dict(d)
    return jscene, lr.compile_scene(jscene), tscene, lt.compile_scene(tscene, device="cpu")


@pytest.fixture(scope="module")
def dispersive_cornell():
    """_dispersive_cornell at 16^2, 2 spp, depth 5, compiled by both
    packages."""
    return _compile_both(_dispersive_cornell(16, 2, 5))


@pytest.fixture(scope="module")
def spectral_cornell():
    """scenes/cornell_spectral.json at 16^2, 2 spp, depth 5, compiled by
    both packages."""
    return _compile_both(_spectral_cornell(16, 2, 5))


# ---------------------------------------------------------------------------
# (a) constants, the fit and the tables
# ---------------------------------------------------------------------------


def test_constants_equal_the_reference():
    assert cie.CIE_Y_INTEGRAL == jcie.CIE_Y_INTEGRAL
    assert hero._ILLUM_NORM == jhero._ILLUM_NORM
    np.testing.assert_array_equal(colorspace.SRGB_FROM_XYZ, jcs.SRGB_FROM_XYZ)
    assert colorspace.SRGB_FROM_XYZ.dtype == np.float32
    np.testing.assert_array_equal(rgb2spec._W, jr2s._W)


def test_fit_rgb_equals_the_reference():
    rgb = np.random.RandomState(11).rand(128, 3)
    np.testing.assert_array_equal(rgb2spec.fit_rgb(rgb), jr2s.fit_rgb(rgb))
    big = rgb * np.array([4.0, 1.0, 0.5])
    for own, ref in zip(rgb2spec.fit_rgb_unbounded(big), jr2s.fit_rgb_unbounded(big)):
        np.testing.assert_array_equal(own, ref)


@pytest.mark.parametrize("res", [8, 24])
def test_lut_equals_the_reference(res):
    own = rgb2spec.lut(res)
    assert own.shape == (3, res, res, res, 3) and own.dtype == np.float32
    np.testing.assert_array_equal(own, jr2s.lut(res))
    assert rgb2spec._lut_path(res).exists()


def test_lut_cache_writes_through_a_temporary_name(tmp_path, monkeypatch):
    """A fresh cache: the table is built, written under a temporary name and
    moved into place, then loaded from the file; a file of the wrong shape
    raises and is never rebuilt over."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(rgb2spec, "_LUT_CACHE", {})
    table = rgb2spec.lut(4)
    path = rgb2spec._lut_path(4)
    assert path.parent == tmp_path and [p.name for p in tmp_path.iterdir()] == [path.name]
    np.testing.assert_array_equal(np.load(path), table)
    np.testing.assert_array_equal(table, rgb2spec.build_lut(4))
    monkeypatch.setattr(rgb2spec, "_LUT_CACHE", {})
    np.save(path, np.zeros((2, 2), np.float32))
    with pytest.raises(RuntimeError, match="coefficient table"):
        rgb2spec.lut(4)
    assert np.load(path).shape == (2, 2)


def test_lut_lookup_np_equals_the_reference():
    table = rgb2spec.lut(8)
    rgb = np.random.RandomState(12).rand(64, 3) * 1.2
    np.testing.assert_array_equal(rgb2spec.lut_lookup_np(table, rgb),
                                  jr2s.lut_lookup_np(table, rgb))


# ---------------------------------------------------------------------------
# (b) the fits and the wavelength sampling
# ---------------------------------------------------------------------------


def _lams(n=512, seed=13):
    lam = np.random.RandomState(seed).uniform(350.0, 840.0, n).astype(np.float32)
    return np.concatenate([lam, np.float32([360.0, 830.0, 560.0, 538.0])])


@pytest.mark.parametrize("fn", ["cie_x", "cie_y", "cie_z", "cie_xyz", "d65"])
def test_cie_fits_match_the_reference(fn):
    lam = _lams()
    own = getattr(cie, fn)(torch.as_tensor(lam)).numpy()
    ref = np.asarray(getattr(jcie, fn)(jnp.asarray(lam)))
    assert own.dtype == np.float32
    # atol: cie_x subtracts a lobe, and where its terms cancel, one ulp of
    # exp (torch's and XLA's differ there) is more than 2e-6 of the value;
    # 1e-8 is an ulp at 0.1, the fits peak near 1
    np.testing.assert_allclose(own, ref, rtol=RTOL, atol=1e-8)
    # the host form: numpy in, numpy out, the reference's arithmetic
    lam64 = lam.astype(np.float64)
    np.testing.assert_array_equal(getattr(cie, fn)(lam64), getattr(jcie, fn)(lam64))


def test_visible_sampling_matches_the_reference():
    u = np.concatenate([np.random.RandomState(14).rand(512),
                        [0.0, 1e-6, 1e-3, 0.5, 1.0 - 1e-3, 1.0 - 1e-6]]).astype(np.float32)
    lam = hero.sample_visible(torch.as_tensor(u))
    np.testing.assert_allclose(lam.numpy(), np.asarray(jhero.sample_visible(jnp.asarray(u))),
                               rtol=RTOL)
    lams = np.concatenate([lam.numpy(), np.float32([300.0, 359.9, 830.1, 900.0])])
    np.testing.assert_allclose(hero.visible_pdf(torch.as_tensor(lams)).numpy(),
                               np.asarray(jhero.visible_pdf(jnp.asarray(lams))), rtol=RTOL)


@pytest.mark.parametrize("dim", [1, 4, 8])
def test_sample_wavelengths_match_the_reference(dim):
    u = np.concatenate([np.random.RandomState(15).rand(256),
                        [0.0, 1e-7, 1e-6, 0.999999, 1.0 - 1e-7]]).astype(np.float32)[:, None]
    own = hero.HeroWavelengthSpectrum(dimension=dim).sample_wavelengths(
        torch.as_tensor(u))
    ref = jhero.HeroWavelengthSpectrum(dimension=dim).sample_wavelengths(
        jnp.asarray(u))
    assert own.lam.shape == (u.shape[0], dim) and own.dimension == dim
    np.testing.assert_allclose(own.lam.numpy(), np.asarray(ref.lam), rtol=RTOL)
    np.testing.assert_allclose(own.pdf.numpy(), np.asarray(ref.pdf), rtol=RTOL)
    # the sRGB model ignores the draws' values
    srgb = spectrum.SRGBSpectrum().sample_wavelengths(torch.as_tensor(u))
    jsrgb = jspec.SRGBSpectrum().sample_wavelengths(jnp.asarray(u))
    np.testing.assert_array_equal(srgb.lam.numpy(), np.asarray(jsrgb.lam))
    np.testing.assert_array_equal(srgb.pdf.numpy(), np.asarray(jsrgb.pdf))


# ---------------------------------------------------------------------------
# (c) the decodes
# ---------------------------------------------------------------------------


def _rgbs():
    rs = np.random.RandomState(16)
    return np.concatenate([
        rs.rand(256, 3), rs.rand(64, 3) * 3.0 - 0.5,  # inside and outside [0, 1]
        np.repeat(np.float32([0.0, 0.18, 0.5, 1.0, 2.0])[:, None], 3, 1),  # greys: ties
        np.float32([[17.0, 12.0, 4.0], [0.725, 0.71, 0.68], [1.0, 0.0, 0.0],
                    [0.0, 1.0, 1.0], [-1.0, 0.5, 0.5]]),
    ]).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    return hero.HeroWavelengthSpectrum(dimension=4), jhero.HeroWavelengthSpectrum(dimension=4)


def _swl_pair(own, ref, n, seed):
    u = np.random.RandomState(seed).rand(n, 1).astype(np.float32)
    return own.sample_wavelengths(torch.as_tensor(u)), ref.sample_wavelengths(jnp.asarray(u))


def test_coeffs_and_decodes_match_the_reference(models):
    own, ref = models
    rgb = _rgbs()
    t_rgb, j_rgb = torch.as_tensor(rgb), jnp.asarray(rgb)
    np.testing.assert_allclose(own._coeffs(t_rgb).numpy(), np.asarray(ref._coeffs(j_rgb)),
                               atol=1e-5, rtol=0)
    swl, jswl = _swl_pair(own, ref, rgb.shape[0], 17)
    for kind in ("albedo", "unbounded", "illuminant"):
        o = getattr(own, "decode_" + kind)(t_rgb, swl).numpy()
        r = np.asarray(getattr(ref, "decode_" + kind)(j_rgb, jswl))
        assert o.shape == (rgb.shape[0], 4)
        np.testing.assert_allclose(o, r, atol=1e-5, rtol=0, err_msg=kind)


def test_coefficient_route_equals_the_per_ray_route(models):
    own, _ = models
    rgb = torch.as_tensor(_rgbs())
    swl, _ = _swl_pair(*models, rgb.shape[0], 18)
    assert torch.equal(own.decode_albedo(rgb, swl),
                       own.decode_albedo_coeffs(own.coeffs_albedo(rgb), swl))
    assert torch.equal(own.decode_unbounded(rgb * 3.0, swl),
                       own.decode_unbounded_coeffs(*own.coeffs_unbounded(rgb * 3.0), swl))
    assert torch.equal(own.decode_illuminant(rgb * 5.0, swl),
                       own.decode_illuminant_coeffs(*own.coeffs_illuminant(rgb * 5.0), swl))


def test_compiled_coefficients_decode_like_the_rows(spectral_cornell):
    """The compiler's coefficient columns are the model's fit of the rows'
    values, and spectral_param on gathered rows equals the per-ray decode."""
    from luisarender_tpu_torch.textures.base import spectral_param

    _, _, _, tcomp = spectral_cornell
    spec = tcomp.spectrum
    matte = tcomp.arrays["surfaces"][0]
    assert torch.equal(matte["kd__ca"], spec.coeffs_albedo(matte["kd"]))
    light = tcomp.arrays["lights"][0]
    ci, cis = spec.coeffs_illuminant(light["emission"])
    assert torch.equal(light["emission__ci"], ci) and torch.equal(light["emission__cis"], cis)
    n = 64
    rows = {k: v[torch.arange(n) % v.shape[0]] for k, v in matte.items()}
    swl = spec.sample_wavelengths(torch.rand(n, 1, generator=torch.Generator().manual_seed(3)))
    assert torch.equal(spectral_param(tcomp, rows, "kd", swl, "albedo"),
                       spec.decode_albedo(rows["kd"], swl))
    lrows = {k: v[torch.zeros(n, dtype=torch.long)] for k, v in light.items()}
    assert torch.equal(spectral_param(tcomp, lrows, "emission", swl, "illuminant"),
                       spec.decode_illuminant(lrows["emission"], swl))


# ---------------------------------------------------------------------------
# (d) integration to sRGB, termination, the dispersive mask
# ---------------------------------------------------------------------------


def test_srgb_integration_matches_the_reference(models):
    own, ref = models
    vals = np.random.RandomState(19).rand(300, 4).astype(np.float32) * 3.0
    swl, jswl = _swl_pair(own, ref, 300, 20)
    # some lanes collapsed to their hero wavelength
    t = torch.arange(300) % 3 == 0
    swl = swl._replace(pdf=torch.where(t[:, None], swl.terminate_secondary().pdf, swl.pdf))
    jswl = jswl._replace(pdf=jnp.where(jnp.asarray(t.numpy())[:, None],
                                       jswl.terminate_secondary().pdf, jswl.pdf))
    np.testing.assert_allclose(swl.pdf.numpy(), np.asarray(jswl.pdf), rtol=RTOL)
    t_vals, j_vals = torch.as_tensor(vals), jnp.asarray(vals)
    np.testing.assert_allclose(spectrum.spectral_to_xyz(t_vals, swl).numpy(),
                               np.asarray(jspec.spectral_to_xyz(j_vals, jswl)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(own.srgb(t_vals, swl).numpy(),
                               np.asarray(ref.srgb(j_vals, jswl)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(own.cie_y(t_vals, swl).numpy(),
                               np.asarray(ref.cie_y(j_vals, jswl)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(spectrum.spectrum_average(t_vals).numpy(),
                               np.asarray(jspec.spectrum_average(j_vals)), rtol=1e-6)
    np.testing.assert_array_equal(spectrum.spectrum_max(t_vals).numpy(),
                                  np.asarray(jspec.spectrum_max(j_vals)))


@pytest.mark.parametrize("dim", [1, 4])
def test_terminate_secondary_matches_the_reference(dim):
    u = np.random.RandomState(21).rand(32, 1).astype(np.float32)
    swl = hero.HeroWavelengthSpectrum(dimension=dim).sample_wavelengths(
        torch.as_tensor(u))
    jswl = jhero.HeroWavelengthSpectrum(dimension=dim).sample_wavelengths(
        jnp.asarray(u))
    term, jterm = swl.terminate_secondary(), jswl.terminate_secondary()
    np.testing.assert_allclose(term.pdf.numpy(), np.asarray(jterm.pdf), rtol=RTOL)
    np.testing.assert_array_equal(term.secondary_terminated().numpy(),
                                  np.asarray(jterm.secondary_terminated()))
    np.testing.assert_array_equal(swl.secondary_terminated().numpy(),
                                  np.asarray(jswl.secondary_terminated()))


def test_dispersive_mask_matches_the_reference(dispersive_cornell):
    _, jcomp, _, tcomp = dispersive_cornell
    n_inst = tcomp.arrays["instances"]["surface_tag"].shape[0]
    inst = np.arange(n_inst, dtype=np.int32).repeat(2)
    valid = np.tile([True, False], n_inst)
    own = surf_base.dispersive_mask(
        tcomp, SimpleNamespace(inst=torch.as_tensor(inst), valid=torch.as_tensor(valid)))
    # the reference's mask reads only the plan and the arrays' instance and
    # cauchy_b columns: its context's coefficient fit (seconds of eager
    # ops here) is left out
    jctx = SimpleNamespace(arrays=jcomp.arrays, plan=jcomp.plan)
    ref = jsurf.dispersive_mask(jctx, SimpleNamespace(inst=jnp.asarray(inst),
                                                      valid=jnp.asarray(valid)))
    assert surf_base.any_dispersive(tcomp) and jsurf.any_dispersive(jctx)
    np.testing.assert_array_equal(own.numpy(), np.asarray(ref))
    assert int(own.sum()) == 1  # the glass sphere, on its valid lane


# ---------------------------------------------------------------------------
# (e) the general fork against the reference, per sample
# ---------------------------------------------------------------------------


def _render_against_reference(jscene, jcomp, tscene, tcomp, spp, depth):
    w, h = tscene.cameras[0].film.resolution
    pxy = _pixels(w, h)
    kw = dict(max_depth=depth, rr_depth=0, rr_threshold=0.95)
    # one compile of the reference's sample
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
        assert np.isfinite(rgb).all() and rgb.shape == (w * h, 3)
        assert _frac_off(rgb, np.asarray(rgb_ref)) < 0.02, si


def test_dispersion_and_unbounded_match_the_reference(dispersive_cornell):
    jscene, jcomp, tscene, tcomp = dispersive_cornell
    names = [c.impl_names[0] for c in tcomp.plan.surface_types]
    assert names == ["matte", "plastic", "glass"] and tcomp.plan.num_tris == 352
    assert tcomp.plan.spectral_dim == 4 and not tcomp.plan.fused_path
    assert "sigma_a__cus" in tcomp.arrays["surfaces"][1]
    assert float(tcomp.arrays["surfaces"][1]["sigma_a__cus"].max()) == 4.0
    _render_against_reference(jscene, jcomp, tscene, tcomp, spp=2, depth=5)


def test_checkerboard_mesh_heavy_matches_the_reference():
    jscene, jcomp, tscene, tcomp = _compile_both(_small_heavy())
    assert "cluster_nodes" in tcomp.arrays["trace"] and tcomp.plan.has_environment
    # the checkerboard survives as a handle: its lanes take the per-ray decode
    assert "kd__h" in tcomp.arrays["surfaces"][0] and "kd__ca" in tcomp.arrays["surfaces"][0]
    _render_against_reference(jscene, jcomp, tscene, tcomp, spp=2, depth=3)


# ---------------------------------------------------------------------------
# (f) the golden and a converted scene
# ---------------------------------------------------------------------------


def test_cpu_render_matches_the_golden():
    scene = lt.Scene.from_dict(_spectral_cornell(48, 8, 8))
    img = lt.render(scene, device="cpu")["cornell_spectral.exr"]
    assert scene.integrator.fused_passes == 0
    ref = jimageio.load_exr(str(GOLDEN))
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert _frac_off(img, ref) < 0.02
    assert abs(float(img.mean() / ref.mean()) - 1.0) < 0.005


def test_converted_hero_scene_renders_like_the_port(spectral_cornell):
    _, jcomp, tscene, tcomp = spectral_cornell
    conv = convert.convert(
        jax.device_get(jcomp.arrays), [c.impl_names[0] for c in jcomp.plan.surface_types],
        [c.impl_names[0] for c in jcomp.plan.light_types], tscene, device="cpu",
        bvh_leaf_size=jcomp.plan.bvh_leaf_size)
    assert conv.spectrum is tscene.spectrum.model() and conv.plan.spectral_dim == 4
    for group in ("surfaces", "lights"):
        for own, cv in zip(tcomp.arrays[group], conv.arrays[group]):
            for k in [k for k in own if "__c" in k]:
                assert torch.equal(own[k], cv[k]), (group, k)
    pxy = torch.as_tensor(_pixels(16, 16))
    kw = dict(max_depth=5, rr_depth=0, rr_threshold=0.95)
    integ = tscene.integrator
    rgb_conv, rgb_own = (
        path_trace_batch(comp, tscene.cameras[0], integ.sampler, integ.light_sampler, pxy, 1,
                         **kw)[0]
        for comp in (conv, tcomp))
    assert torch.equal(rgb_conv, rgb_own)


def test_hero_helper_makes_disney_plastic():
    """testing.hero (chip_smoke.py's full-size mesh-heavy scene under hero)
    gives each Disney sphere a plastic surface of its colour and roughness."""
    ref = testing.mesh_heavy(res=(16, 9), spp=1, depth=2, n=2, subdiv=1)
    d = testing.hero(testing.mesh_heavy(res=(16, 9), spp=1, depth=2, n=2, subdiv=1), 8)
    assert d["render"]["spectrum"] == {"impl": "hero", "prop": {"dimension": 8}}
    pairs = [(a["prop"]["surface"], b["prop"]["surface"])
             for a, b in zip(ref["render"]["shapes"], d["render"]["shapes"])]
    spheres = [(a, b) for a, b in pairs if a["impl"] == "disney"]
    assert len(spheres) == 4
    for a, b in spheres:
        assert b == {"impl": "plastic", "prop": {"Kd": a["prop"]["color"],
                                                 "roughness": a["prop"]["roughness"]}}
    assert all(a == b for a, b in pairs if a["impl"] != "disney")
    compiled = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    assert [c.impl_names[0] for c in compiled.plan.surface_types] == ["matte", "plastic"]
    assert compiled.plan.spectral_dim == 8


# ---------------------------------------------------------------------------
# (g) refusals
# ---------------------------------------------------------------------------


def _disney_cornell():
    d = testing.cornell_box(resolution=(8, 8), spp=1, depth=2)
    d["render"]["shapes"][6]["prop"]["surface"] = {"impl": "disney", "prop": {
        "color": {"impl": "constant", "prop": {"v": [0.7, 0.3, 0.2]}}}}
    d["render"]["spectrum"] = {"impl": "hero", "prop": {"dimension": 4}}
    return d


@pytest.mark.parametrize("dim", [3, 4])
def test_disney_under_hero_raises(dim):
    d = _disney_cornell()
    d["render"]["spectrum"]["prop"]["dimension"] = dim
    with pytest.raises(NotImplementedError, match="disney.py:344"):
        lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    # the reference compiles it and fails only while it renders; its tables
    # carried across are refused the same way
    require_reference_builder()
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    with pytest.raises(NotImplementedError, match="disney.py:344"):
        convert.convert(jax.device_get(jcomp.arrays),
                        [c.impl_names[0] for c in jcomp.plan.surface_types],
                        [c.impl_names[0] for c in jcomp.plan.light_types],
                        lt.Scene.from_dict(d), device="cpu",
                        bvh_leaf_size=jcomp.plan.bvh_leaf_size)
    # the same scene in sRGB compiles
    del d["render"]["spectrum"]
    lt.compile_scene(lt.Scene.from_dict(d), device="cpu")


@pytest.mark.parametrize("dim", [0, 9])
def test_hero_dimension_out_of_range_raises(dim):
    d = _spectral_cornell(8, 1, 2)
    d["render"]["spectrum"]["prop"]["dimension"] = dim
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        lt.Scene.from_dict(d)
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        lr.Scene.from_dict(d)


def test_hero_never_takes_the_fused_fork(spectral_cornell):
    import dataclasses

    _, _, tscene, tcomp = spectral_cornell
    assert not tcomp.plan.fused_path and "fused" not in tcomp.arrays
    forced = dataclasses.replace(tcomp, plan=dataclasses.replace(tcomp.plan, fused_path=True))
    integ = tscene.integrator
    with pytest.raises(RuntimeError, match="fused fork"):
        path_trace_batch(forced, tscene.cameras[0], integ.sampler, integ.light_sampler,
                         torch.as_tensor(_pixels(4, 4)), 0, max_depth=2, rr_depth=0,
                         rr_threshold=0.95)
