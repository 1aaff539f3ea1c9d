"""The port's wavefront integrator (luisarender_tpu_torch/integrators/
wave_path.py, `wavepath`) and the film's pool splats against the
reference:

(a) the Cornell box (32^2, 8 spp, depth 4, a pool of 256 slots: four tiles
    and refills, 4 iterations a check) against tests/golden/
    wavepath_32_8spp.exr, the reference's render on its general pool: the
    general pool (LUISARENDER_TPU_NO_FUSED=1) by its rule (under 2% of
    pixels off by more than 1e-3, the mean within 0.5%); the fused pool
    (the persistent kernel's plain version) by its mean and each fused
    sample against the general fork by the reference's per-sample rule,
    as tests/test_torch_render.py holds the fused fork;
(b) when a path starts cannot change the image: the general pool's image
    and ray count equal megapath's general fork bit for bit (under the
    independent sampler and under pmj02bn, whose state holds a vector a
    lane), the fused pool's (spp <= samples_per_pass) megawave's;
(c) the film's weight channel is spp on every pixel (a pool of 64 on 8^2
    at 5 spp), and a second render is bit-identical, on both pools;
(d) films/base.py accumulate_linear and accumulate_scatter against the
    reference's (rtol 1e-6), dead lanes and NaNs included;
(e) the names and aliases, and no render without a card unless the caller
    passes device="cpu".
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.integrators.mega_path import (
    general_path_trace_batch, path_trace_batch, pixel_grid,
)
from luisarender_tpu_torch.utils import imageio

from torch_parity import require_reference_builder

GOLDEN = Path(__file__).resolve().parent / "golden" / "wavepath_32_8spp.exr"
POOLS = ("general", "fused")


def _wave_scene(res, spp, depth, state_count, iterations=4):
    return lt.Scene.from_dict(testing.wavepath(
        testing.cornell_box(resolution=res, spp=spp, depth=depth),
        state_count=state_count, iterations_per_launch=iterations))


def _render(scene, pool, monkeypatch):
    if pool == "general":
        monkeypatch.setenv("LUISARENDER_TPU_NO_FUSED", "1")
    else:
        monkeypatch.delenv("LUISARENDER_TPU_NO_FUSED", raising=False)
    img = lt.render(scene, device="cpu")["cornell.exr"]
    integ = scene.integrator
    if pool == "general":
        assert integ.fused_passes == 0 and integ.iterations_run > 0 and integ.refills > 0
    else:
        assert integ.iterations_run == 0 and integ.fused_passes > 0
    return img


def _frac_off(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) > 1e-3).mean())


def test_general_pool_matches_golden(monkeypatch):
    require_reference_builder()
    scene = _wave_scene((32, 32), 8, 4, 256)
    img = _render(scene, "general", monkeypatch)
    integ = scene.integrator
    # one dead count an iteration, one all-done flag a block of 4
    assert integ.host_reads == integ.iterations_run + integ.iterations_run // 4
    ref = imageio.load_exr(str(GOLDEN))
    assert _frac_off(img, ref) < 0.02
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005


def test_fused_pool_matches_golden(monkeypatch):
    """The fused pool runs the fused fork's paths, which flip on rounding at
    a boundary now and then against the general fork's (tests/
    test_torch_render.py test_render_matches_golden): over these 8 samples
    2.6% of the pixels differ from the golden by more than 1e-3. So, as
    there, the image is held by its mean, and each of its samples (a
    fused launch of one sample) against the general fork's by the
    reference's rule for its fused kernel."""
    require_reference_builder()
    scene = _wave_scene((32, 32), 8, 4, 256)
    img = _render(scene, "fused", monkeypatch)
    assert scene.integrator.fused_passes == 4  # one persistent launch a tile
    ref = imageio.load_exr(str(GOLDEN))
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005

    comp = lt.compile_scene(scene, device="cpu")
    integ, camera = scene.integrator, scene.cameras[0]
    pxy = pixel_grid(32, 32, "cpu")
    kw = dict(max_depth=4, rr_depth=0, rr_threshold=0.95)
    for si in range(8):
        args = (comp, camera, integ.sampler, integ.light_sampler, pxy, si)
        rgb_f, _, st_f = path_trace_batch(*args, with_stats=True, **kw)
        rgb_g, _, st_g = general_path_trace_batch(*args, **kw)
        assert st_f["fused"] == 1
        assert abs(int(st_f["rays"]) - int(st_g["rays"])) <= max(8, int(st_g["rays"]) // 500)
        assert _frac_off(rgb_f.numpy(), rgb_g.numpy()) < 0.02


@pytest.mark.parametrize("pool", POOLS)
def test_pool_equals_megapath(pool, monkeypatch):
    """The general pool against megapath's general fork at 8 spp; the fused
    pool against megawave at 4 spp (one pass of samples_per_pass 4)."""
    spp = 8 if pool == "general" else 4
    wave = _wave_scene((16, 16), spp, 4, 96)  # three tiles, the last one short
    img = _render(wave, pool, monkeypatch)
    mega = lt.Scene.from_dict(testing.cornell_box(
        resolution=(16, 16), spp=spp, depth=4,
        integrator="megapath" if pool == "general" else "megawave"))
    ref = lt.render(mega, device="cpu")["cornell.exr"]
    np.testing.assert_array_equal(img, ref)
    assert wave.integrator.rays_traced == mega.integrator.rays_traced > 0


def test_pool_under_pmj02bn_equals_megapath():
    """A sampler state with a per-lane vector (pmj02bn's blue-noise values,
    (N, 3) lanes first) through the pool's refills: the image equals
    megapath's. The reference's pool fails here: its (3, N) values do not
    broadcast against the (N, 1) refill mask (ROADMAP Queue 3)."""
    d = testing.cornell_box(resolution=(12, 12), spp=3, depth=3)
    wave = lt.Scene.from_dict(testing.with_sampler(
        testing.wavepath(testing.cornell_box(resolution=(12, 12), spp=3, depth=3),
                         state_count=64, iterations_per_launch=4), "pmj02bn"))
    img = lt.render(wave, device="cpu")["cornell.exr"]
    assert wave.integrator.refills > 0 and wave.integrator.fused_passes == 0
    mega = lt.Scene.from_dict(testing.with_sampler(d, "pmj02bn"))
    np.testing.assert_array_equal(img, lt.render(mega, device="cpu")["cornell.exr"])


@pytest.mark.parametrize("pool", POOLS)
def test_film_weights_are_spp(pool, monkeypatch):
    scene = _wave_scene((8, 8), 5, 2, 64)
    film = scene.cameras[0].film
    developed = []
    develop = film.develop

    def keep(accum):
        developed.append(accum.clone())
        return develop(accum)

    monkeypatch.setattr(film, "develop", keep)
    a = _render(scene, pool, monkeypatch)
    b = _render(scene, pool, monkeypatch)
    np.testing.assert_array_equal(a, b)
    for accum in developed:
        np.testing.assert_array_equal(accum[..., 3].numpy(), np.full((8, 8), 5.0, np.float32))


def _splat_inputs(n, seed):
    rs = np.random.RandomState(seed)
    radiance = (rs.rand(n, 3) * 400.0 - 20.0).astype(np.float32)  # some past the clamp
    radiance[::7, 1] = np.nan
    radiance[::11, 2] = np.inf
    weight = rs.rand(n).astype(np.float32) * 2.0
    weight[::5] = 0.0  # dead lanes
    accum = (rs.rand(6, 7, 4) * 3.0).astype(np.float32)
    return accum, radiance, weight


def _films():
    d = testing.cornell_box(resolution=(7, 6), spp=1)
    d["render"]["cameras"][0]["prop"]["film"]["prop"]["clamp"] = 100.0
    return lr.Scene.from_dict(d).cameras[0].film, lt.Scene.from_dict(d).cameras[0].film


@pytest.mark.parametrize("start,n", [(0, 42), (10, 20), (30, 25)])
def test_accumulate_linear_matches_reference(start, n):
    jfilm, tfilm = _films()
    accum, radiance, weight = _splat_inputs(n, start + n)
    want = jfilm.accumulate_linear(jnp.asarray(accum), start, jnp.asarray(radiance),
                                   jnp.asarray(weight))
    got = tfilm.accumulate_linear(torch.as_tensor(accum), start, torch.as_tensor(radiance),
                                  torch.as_tensor(weight))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_accumulate_scatter_matches_reference():
    jfilm, tfilm = _films()
    accum, radiance, weight = _splat_inputs(300, 9)
    rs = np.random.RandomState(10)
    pixel_ids = np.stack([rs.randint(-2, 9, 300), rs.randint(-2, 8, 300)], -1).astype(np.int32)
    want = jfilm.accumulate_scatter(jnp.asarray(accum), jnp.asarray(pixel_ids),
                                    jnp.asarray(radiance), jnp.asarray(weight))
    got = tfilm.accumulate_scatter(torch.as_tensor(accum), torch.as_tensor(pixel_ids),
                                   torch.as_tensor(radiance), torch.as_tensor(weight))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_names_aliases_and_card_default():
    from luisarender_tpu_torch.integrators.wave_path import WavefrontPathTracing
    from luisarender_tpu_torch.scene.node import SceneNodeTag
    from luisarender_tpu_torch.scene.registry import lookup

    for name in ("wavepath", "WavePath", "wavefront", "wavepathv2", "WavePathV2"):
        assert lookup(SceneNodeTag.INTEGRATOR, name) is WavefrontPathTracing
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            lt.render(_wave_scene((8, 8), 1, 2, 64))
