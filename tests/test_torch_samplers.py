"""The port's low-discrepancy samplers (luisarender_tpu_torch/samplers/lds.py)
against the reference's (luisarender_tpu/samplers/lds.py):

(a) the building blocks bit-equal: the 32-bit reversal, `sobol_2d` and
    `owen_scramble` on random words, the Sobol direction numbers' 64-
    dimension prefix (core/sobolgen.py, uncached), the PMJ02 tables
    (`_generate_pmj02(1024, 7919 + i)`) and the blue-noise ranks
    (core/bluenoise.py `generate_bluenoise_ranks(64, s)`);
(b) each sampler's `start`, `generate_pixel_2d`, `generate_1d` and
    `generate_2d` over 64 pixels x 4 sample indices x 12 dimensions, every
    state word and every draw bit-equal;
(c) each sampler's Cornell box (32^2, 4 spp, depth 4, the general fork: a
    sampler other than independent makes a scene ineligible for the fused
    fork) against tests/golden/cornell_<impl>_32_4spp.exr, the reference's
    render, by its rule: under 2% of pixels off by more than 1e-3, the mean
    within 0.5%.

The reference caches its PMJ02 tables and blue noise under
LUISARENDER_TPU_CACHE, pointed here at a temporary directory; the port
caches under luisarender_tpu_torch/_build/. Both packages' `sobol_matrices`
are patched to one shared table (the 64-dimension prefix, repeated to
1,024 rows), so that no test pays the 1,024-dimension search; the renders
here read fewer than 64 dimensions.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu.core import bluenoise as jbn
from luisarender_tpu.core import sobolgen as jsg
from luisarender_tpu.samplers import lds as jlds
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.core import bluenoise as tbn
from luisarender_tpu_torch.core import rng as trng
from luisarender_tpu_torch.core import sobolgen as tsg
from luisarender_tpu_torch.samplers import lds as tlds
from luisarender_tpu_torch.utils import imageio

from torch_parity import require_reference_builder

GOLDEN = Path(__file__).resolve().parent / "golden"
IMPLS = ("paddedsobol", "sobol", "zsobol", "pmj02bn", "tileshared")
ALIASES = {"paddedsobol": ("PaddedSobol", "padded_sobol"), "sobol": ("Sobol",),
           "zsobol": ("ZSobol",), "pmj02bn": ("PMJ02BN", "pmj02", "PMJ02"),
           "tileshared": ("TileShared", "tile_shared")}
# the draws of (b): generate_pixel_2d, then 1D and 2D draws mixed so that a
# 2D draw also starts at an odd dimension; 12 dimensions in all
DRAWS = ("pixel_2d", "1d", "2d", "2d", "1d", "2d", "1d", "1d")


@pytest.fixture(scope="module")
def shared_sobol(tmp_path_factory):
    """Both packages' sobol_matrices patched to one table, the reference's
    caches in a temporary directory."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LUISARENDER_TPU_CACHE", str(tmp_path_factory.mktemp("ref_cache")))
    table = np.resize(jsg.sobol_matrices(64, cache=False), (1024, 32))

    def shared(n_dims=1024, *args, **kw):
        return table[:n_dims]

    mp.setattr(jsg, "sobol_matrices", shared)
    mp.setattr(tsg, "sobol_matrices", shared)
    yield table
    mp.undo()


def _samplers(impl):
    d = testing.with_sampler(testing.cornell_box(resolution=(8, 8), spp=1), impl, seed=4711)
    return lr.Scene.from_dict(d).integrator.sampler, lt.Scene.from_dict(d).integrator.sampler


def _words(n, seed):
    w = np.random.RandomState(seed).randint(0, 2**32, n, dtype=np.int64)
    w[:4] = (0, 1, 2**31, 2**32 - 1)
    return w


# --------------------------------------------------------------------------
# (a) the building blocks
# --------------------------------------------------------------------------


def test_bit_reversal_sobol_2d_and_owen_scramble():
    w = _words(4096, 1)
    seeds = _words(4096, 2)
    jw = jnp.asarray(w.astype(np.uint32))
    tw = torch.as_tensor(w)
    np.testing.assert_array_equal(trng.reverse_bits32(tw).numpy(),
                                  np.asarray(jlds._reverse_bits32(jw)).astype(np.int64))
    for got, want in zip(tlds.sobol_2d(tw), jlds.sobol_2d(jw)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    got = tlds.owen_scramble(tw, torch.as_tensor(seeds))
    want = jlds.owen_scramble(jw, jnp.asarray(seeds.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_sobol_matrix_prefix_matches_reference():
    got = tsg.sobol_matrices(64, cache=False)
    want = jsg.sobol_matrices(64, cache=False)
    assert got.dtype == np.uint32 and got.shape == (64, 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("table", range(5))
def test_pmj02_tables_match_reference(table):
    got = tlds._generate_pmj02(1024, 7919 + table)
    want = jlds._generate_pmj02(1024, 7919 + table)
    assert got.dtype == np.float32 and got.shape == (1024, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_bluenoise_ranks_match_reference(seed):
    got = tbn.generate_bluenoise_ranks(64, seed)
    np.testing.assert_array_equal(got, jbn.generate_bluenoise_ranks(64, seed))
    assert sorted(got.reshape(-1).tolist()) == list(range(64 * 64))


# --------------------------------------------------------------------------
# (b) the draws
# --------------------------------------------------------------------------


def _state_equal(impl, ref, port):
    assert sorted(ref) == sorted(port), impl
    for k in ref:
        want = np.asarray(ref[k])
        got = port[k].numpy()
        if k == "bn":  # the reference's (3, ...), the port's lanes first
            got = np.moveaxis(got, -1, 0)
        else:
            want = want.astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=f"{impl} state[{k}]")


@pytest.mark.parametrize("impl", IMPLS)
def test_draws_match_reference(shared_sobol, impl):
    """64 pixels (some past the 64^2 blue-noise texture, in several tiles)
    at 4 sample indices, as (4, 64) lanes."""
    jsam, tsam = _samplers(impl)
    assert type(tsam).__name__ == type(jsam).__name__
    pxy = np.random.RandomState(3).randint(0, 300, (64, 2)).astype(np.int32)
    pxy = np.broadcast_to(pxy, (4, 64, 2)).copy()
    si = np.broadcast_to(np.array([[0], [1], [5], [1000]], np.int32), (4, 64)).copy()
    js = jsam.start(jnp.asarray(pxy), jnp.asarray(si))
    ts = tsam.start(torch.as_tensor(pxy), torch.as_tensor(si))
    _state_equal(impl, js, ts)
    for k, op in enumerate(DRAWS):
        name = "generate_" + op
        js, ju = getattr(jsam, name)(js)
        ts, tu = getattr(tsam, name)(ts)
        assert tu.dtype == torch.float32
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju),
                                      err_msg=f"{impl} draw {k} ({op})")
    _state_equal(impl, js, ts)
    assert bool((ts["dim"] == 12).all())


@pytest.mark.parametrize("impl", IMPLS)
def test_names_and_aliases_register(impl):
    from luisarender_tpu_torch.scene.node import SceneNodeTag
    from luisarender_tpu_torch.scene.registry import lookup

    cls = lookup(SceneNodeTag.SAMPLER, impl)
    assert all(lookup(SceneNodeTag.SAMPLER, a) is cls for a in ALIASES[impl])
    assert cls.__module__ == "luisarender_tpu_torch.samplers.lds"


# --------------------------------------------------------------------------
# (c) the goldens
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_golden_cornell(shared_sobol, impl):
    require_reference_builder()
    scene = lt.Scene.from_dict(testing.with_sampler(
        testing.cornell_box(resolution=(32, 32), spp=4, depth=4), impl))
    img = lt.render(scene, device="cpu")["cornell.exr"]
    integ = scene.integrator
    assert integ.fused_passes == 0 and integ.bounces_run > 0, "took the fused fork"
    ref = imageio.load_exr(str(GOLDEN / f"cornell_{impl}_32_4spp.exr"))
    assert img.shape == ref.shape == (32, 32, 3)
    frac = float((np.abs(img - ref).max(-1) > 1e-3).mean())
    rel = float(img.mean() / ref.mean() - 1.0)
    assert frac < 0.02 and abs(rel) < 0.005, (frac, rel)
