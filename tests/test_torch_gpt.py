"""The port's gradient-domain path tracer (luisarender_tpu_torch/
integrators/gpt.py) against the JAX package's, on the CPU:

(a) gpt_trace_batch at 16^2, depth 4, on testing.cornell_box (every shift
    a reconnection or a reflective half-vector shift) and on the
    reference's glass scene (tests/test_gpt.py _glass_scene: a glass
    sphere over much of the view, so the transmissive half-vector branch
    runs), each of 2 samples against the reference's jitted sample (one
    compile a scene): very_direct, radiance, neighbor and gradient by the
    goldens' rule (under 2% of lanes off by more than 1e-3), shift_alive
    equal on at least 99.9% of the 4N lanes; the shifted pixels of the
    border (x = -1, x = w, y = -1, y = h) included;
(b) reconstruct_l2 on equal inputs within 1e-5 relative;
(c) a 32^2, 4-spp, depth-4 render against tests/golden/gpt_32_4spp.exr
    (the reference's reconstructed CPU render) by the goldens' rule, the
    mean within 0.5%, and its three aux buffers named and shaped as the
    reference's (`{stem}_{key}{ext}`), saved beside the image.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu.integrators import gpt as jgpt
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.integrators import gpt
from luisarender_tpu_torch.utils import imageio

import torch_parity
from test_gpt import _glass_scene

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "gpt_32_4spp.exr"
RES = 16
SAMPLES = 2
AUX = ("gradient_x", "gradient_y", "effective")


def _cornell(res=RES, spp=SAMPLES):
    d = testing.cornell_box(resolution=(res, res), spp=spp, depth=6)
    d["render"]["integrator"] = {"impl": "gpt", "prop": {"depth": 4}}
    return d


def _pixels(w, h):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)


def _frac_off(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) > 1e-3).mean())


_SAMPLES = {}


def _samples(which):
    """Both packages' SAMPLES samples of a scene: [(port, reference)]."""
    if which not in _SAMPLES:
        torch_parity.require_reference_builder()
        d = _cornell() if which == "cornell" else _glass_scene(SAMPLES, depth=4, integrator="gpt")
        jscene = lr.Scene.from_dict(d)
        jcomp = lr.compile_scene(jscene)
        tscene = lt.Scene.from_dict(d)
        tcomp = lt.compile_scene(tscene, device="cpu")
        ji, ti = jscene.integrator, tscene.integrator
        assert ti.max_depth == ji.max_depth == 4
        pxy = _pixels(RES, RES)
        ref_sample = jax.jit(lambda arrays, si: jgpt.gpt_trace_batch(
            jcomp, arrays, jscene.cameras[0], ji.sampler, ji.light_sampler, jnp.asarray(pxy),
            si, max_depth=ji.max_depth, rr_depth=ji.rr_depth, rr_threshold=ji.rr_threshold,
            shift_threshold=ji.shift_threshold))
        out = []
        for si in range(SAMPLES):
            ref = jax.device_get(ref_sample(jcomp.arrays, jnp.int32(si)))
            got = ti.sample(tcomp, tscene.cameras[0], torch.as_tensor(pxy), si)
            out.append(({k: v.numpy() for k, v in got.items()}, ref))
        _SAMPLES[which] = out
    return _SAMPLES[which]


@pytest.mark.parametrize("which", ["cornell", "glass"])
def test_samples_match_reference(which):
    for got, ref in _samples(which):
        assert set(got) == set(ref)
        for k in ("very_direct", "radiance", "neighbor", "gradient"):
            assert got[k].shape == ref[k].shape and np.isfinite(got[k]).all(), k
            assert _frac_off(got[k], ref[k]) < 0.02, (k, _frac_off(got[k], ref[k]))
        assert got["shift_alive"].shape == (4 * RES * RES,)
        assert (got["shift_alive"] == ref["shift_alive"]).mean() >= 0.999
        np.testing.assert_array_equal(got["weight"], ref["weight"])
        assert got["radiance"].mean() > 0.0 and np.abs(got["gradient"]).mean() > 0.0


def test_glass_scene_reaches_transmission():
    """The glass sphere's closure refracts (eta 1.5) and the shifted paths
    meet it: the transmissive branch's lanes are live."""
    d = _glass_scene(1, depth=4, integrator="gpt")
    tcomp = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    assert tcomp.plan.num_spheres == 1
    assert [c.__name__ for c in tcomp.plan.surface_types] == ["MatteSurface", "GlassSurface"]
    got = _samples("glass")[0][0]
    # the sphere covers the view's middle: its shifts stay alive through it
    alive = got["shift_alive"].reshape(4, RES, RES)[:, 4:12, 4:12]
    assert alive.mean() > 0.05


def test_shifted_pixels_leave_the_film():
    pxy = torch.as_tensor(_pixels(RES, RES))
    sh = gpt.shifted_pixels(pxy).reshape(4, RES, RES, 2)
    assert int(sh[0, :, -1, 0].max()) == RES and int(sh[2, :, 0, 0].min()) == -1
    assert int(sh[1, -1, :, 1].max()) == RES and int(sh[3, 0, :, 1].min()) == -1


def test_reconstruct_l2_matches_reference():
    rng = np.random.default_rng(6)
    primal = rng.uniform(0.0, 1.0, (RES, 24, 3)).astype(np.float32)
    gx = rng.normal(0.0, 0.1, (RES, 24, 3)).astype(np.float32)
    gy = rng.normal(0.0, 0.1, (RES, 24, 3)).astype(np.float32)
    ref = np.asarray(jgpt.reconstruct_l2(jnp.asarray(primal), jnp.asarray(gx), jnp.asarray(gy)))
    got = gpt.reconstruct_l2(*(torch.as_tensor(x) for x in (primal, gx, gy))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(got - primal).max() > 1e-3


def test_render_matches_golden(tmp_path):
    d = _cornell(res=32, spp=4)
    d["render"]["cameras"][0]["prop"]["file"] = str(tmp_path / "cornell.exr")
    images = lt.render(lt.Scene.from_dict(d), save=True, device="cpu")
    assert set(images) == {str(tmp_path / f"cornell{s}.exr")
                           for s in ("",) + tuple("_" + k for k in AUX)}
    for path, img in images.items():
        assert img.shape == (32, 32, 3) and np.isfinite(img).all(), path
        np.testing.assert_array_equal(imageio.load_exr(path), img)
    img = images[str(tmp_path / "cornell.exr")]
    ref = imageio.load_exr(str(GOLDEN))
    assert (np.abs(img - ref).max(-1) > 1e-3).mean() < 0.02
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005
    eff = images[str(tmp_path / "cornell_effective.exr")]
    assert 0.0 < eff.mean() <= 4.0
