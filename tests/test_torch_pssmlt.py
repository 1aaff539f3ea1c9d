"""The port's PSSMLT (luisarender_tpu_torch/integrators/pssmlt.py) against
the JAX package's, on the CPU:

(a) PSSSampler's draws bit for bit against the reference's, the replayed
    dimensions and those past them (the hash of chain, dimension, salt);
(b) the Kelemen mutation: its floored modulo bit for bit on edge values
    (u + dv just above 1, u - dv just below 0, and u - dv so small a
    negative that float32 rounds u - dv + 1 to exactly 1.0), where both
    packages' dv agree; on random values within one float32 step near 1
    (XLA's exp and torch's differ in the last bit on ~9% of inputs, so dv
    does too);
(c) the chains on testing.cornell_box at 16^2, 16 spp, depth 6, 1,024
    chains, two bootstrap rounds (4 mutations): the bootstrap's b within
    1e-5 relative and the chains' first states bit for bit, then after
    each of the 4 mutations each chain's state (u, luminance, pixel) and
    accept decision, on at least 99.9% of the chains, against the
    reference's bootstrap and mutation step, built as its
    _render_one_camera builds them around its jitted `_trace`; the splat
    image by the goldens' rule (under 2% of pixels off by more than 1e-3);
(d) a PSSMLT render never takes the fused fork (its sampler is not the
    independent one);
(e) a 32^2, 4-spp render (1,024 chains, 4,096 bootstrap paths: 4
    mutations) against tests/golden/pssmlt_32_4spp.exr, the reference's
    CPU render, by the goldens' rule, the mean within 0.5%.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu.core import rng as jrng
from luisarender_tpu.integrators.pssmlt import PSSMLT as JPSSMLT
from luisarender_tpu.integrators.pssmlt import PSSSampler as JPSSSampler
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.integrators import pssmlt
from luisarender_tpu_torch.utils import imageio

import torch_parity

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "pssmlt_32_4spp.exr"
CHAINS = 1024
STEPS = 4


def _scene(res, spp, bootstrap):
    d = testing.cornell_box(resolution=(res, res), spp=spp, depth=6)
    d["render"]["integrator"] = {"impl": "pssmlt", "prop": {
        "depth": 6, "chains": CHAINS, "bootstrap": bootstrap}}
    return d


# ---------------------------------------------------------------------------
# (a) the sampler, (b) the mutation
# ---------------------------------------------------------------------------


def test_pss_sampler_draws_bitwise():
    rng = np.random.default_rng(2)
    n, dims = 777, 9
    u = rng.uniform(size=(n, dims)).astype(np.float32)
    pxy = np.zeros((n, 2), np.int32)
    js, ts = JPSSSampler(dims), pssmlt.PSSSampler(dims)
    js.current_u, ts.current_u = jnp.asarray(u), torch.as_tensor(u)
    jstate, tstate = js.start(jnp.asarray(pxy), 5), ts.start(torch.as_tensor(pxy), 5)
    for step in range(8):
        if step % 2:
            jstate, ju = js.generate_2d(jstate)
            tstate, tu = ts.generate_2d(tstate)
        else:
            jstate, ju = js.generate_1d(jstate)
            tstate, tu = ts.generate_1d(tstate)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju), err_msg=str(step))
    # twelve draws: dims 0-8 replayed, 9-11 hashed
    assert tstate["dim"] == 12 and int(jstate["dim"][0]) == 12
    assert not np.isin(tu.numpy(), u).any()


def _both_mutate(u, u_rand, pick):
    ref = np.asarray(JPSSMLT._mutate(jnp.asarray(u), jnp.asarray(u_rand), jnp.asarray(pick),
                                     5e-3))
    got = pssmlt.mutate(torch.as_tensor(u), torch.as_tensor(u_rand), torch.as_tensor(pick))
    return got.numpy(), ref


def test_mutate_edges_bitwise():
    s2 = np.float32(1.0 / 64.0)
    # u_rand 0.5: u - dv, dv = 1/64 exactly; just below 0.5: u + dv, dv a
    # hair under 1/64
    r_minus, r_plus = np.float32(0.5), np.float32(0.5 - 2.0 ** -25)
    cases = [  # (u, u_rand)
        (1.0 - 2.0 ** -8, r_plus),  # u + dv past 1: wraps to a small number
        (1.0 - 2.0 ** -24, r_plus),  # the largest u below 1
        (1.0 - s2, r_plus),  # u + dv rounds to 1.0: wraps to 0
        (2.0 ** -8, r_minus),  # u - dv below 0: wraps below 1
        (0.0, r_minus),
        (np.nextafter(s2, np.float32(0.0)), r_minus),  # u - dv = -2^-30: + 1 is 1.0
        (s2, r_minus),  # u - dv = 0
        (0.5, r_minus), (0.5, r_plus),
    ]
    u = np.asarray([[c[0] for c in cases]], np.float32)
    r = np.asarray([[c[1] for c in cases]], np.float32)
    # both packages' dv agree on these numbers
    dv_ref = np.asarray(np.float32(1 / 64) * jnp.exp(-jnp.log(16.0) * jnp.abs(2.0 * r - 1.0)))
    dv = (np.float32(1 / 64) * torch.exp(-np.float32(np.log(16.0))
                                         * torch.abs(2.0 * torch.as_tensor(r) - 1.0))).numpy()
    np.testing.assert_array_equal(dv, dv_ref)
    got, ref = _both_mutate(u, r, np.zeros(1, bool))
    np.testing.assert_array_equal(got, ref)
    got = got[0]
    assert 0.0 < got[0] < s2 and 0.0 < got[1] < s2
    # the floored modulo: 1.0 % 1 is 0, and -2^-30 % 1 rounds to exactly 1.0
    # (torch.fmod would keep it negative)
    assert got[2] == 0.0 and got[5] == 1.0 and got[6] == 0.0
    assert 1.0 - s2 < got[3] < 1.0 and got[4] == 1.0 - s2
    # a large step takes the fresh numbers as they are
    got_l, ref_l = _both_mutate(u, r, np.ones(1, bool))
    np.testing.assert_array_equal(got_l, r)
    np.testing.assert_array_equal(ref_l, r)


def test_mutate_random_within_an_ulp():
    rng = np.random.default_rng(4)
    u = rng.uniform(size=(20000, 52)).astype(np.float32)
    r = rng.uniform(size=(20000, 52)).astype(np.float32)
    pick = rng.uniform(size=20000) < 0.3
    got, ref = _both_mutate(u, r, pick)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -23)
    assert (got == ref).mean() > 0.99


# ---------------------------------------------------------------------------
# (c) the chains
# ---------------------------------------------------------------------------


def _reference_block(salt, n, d):
    """The reference's uniform block: element (i, j) from xxhash32(i, j,
    salt) (pssmlt.py uniform_block)."""
    ids = jnp.arange(n, dtype=jnp.uint32)
    return jnp.stack([jrng.uniform_u32_to_float(jrng.xxhash32(ids, jnp.uint32(j),
                                                              jnp.uint32(salt)))
                      for j in range(d)], axis=-1)


@pytest.fixture(scope="module")
def chains():
    """The reference's chains step by step, its jitted `_trace` compiled
    once: b, u0, then (state, accept) after each mutation, and the image."""
    torch_parity.require_reference_builder()
    d = _scene(16, 16, 2 * CHAINS)
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    ji, cam = jscene.integrator, jscene.cameras[0]
    dims = ji._dims()
    sampler = JPSSSampler(dims - 2)
    trace = jax.jit(lambda a, u: ji._trace(jcomp, a, cam, sampler, u))
    arrays = jcomp.arrays
    # the bootstrap (pssmlt.py bootstrap_fn)
    rounds = ji.bootstrap // CHAINS
    us = [_reference_block(1000 + r, CHAINS, dims) for r in range(rounds)]
    lums = [trace(arrays, u)[1] for u in us]
    total = jnp.float32(0.0)
    for lum in lums:
        total = total + jnp.mean(lum)
    pick = jnp.argmax(jnp.stack(lums), axis=0)
    u0 = jnp.take_along_axis(jnp.stack(us), pick[None, :, None], axis=0)[0]
    b = total / rounds
    # the mutations (pssmlt.py mutate_step)
    rgb, lum, pix = trace(arrays, u0)
    state = (u0, rgb, lum, pix)
    splat = jnp.zeros((16, 16, 3), jnp.float32)
    steps = []
    ids = jnp.arange(CHAINS, dtype=jnp.uint32)
    for m in range(STEPS):
        salt = jnp.uint32(2_000_003 + m)
        u, rgb, lum, pix = state
        u_rand = _reference_block(2_000_003 + m, CHAINS, dims)
        pick_large = jrng.uniform_u32_to_float(jrng.xxhash32(ids, salt, jnp.uint32(7))) < ji.p_large
        u_prop = JPSSMLT._mutate(u, u_rand, pick_large, ji.sigma)
        rgb_p, lum_p, pix_p = trace(arrays, u_prop)
        a = jnp.clip(lum_p / jnp.maximum(lum, 1e-12), 0.0, 1.0)
        accept = jrng.uniform_u32_to_float(jrng.xxhash32(ids, salt, jnp.uint32(13))) < a
        w_prop = jnp.where(lum_p > 0, a / jnp.maximum(lum_p, 1e-12), 0.0)
        w_cur = jnp.where(lum > 0, (1.0 - a) / jnp.maximum(lum, 1e-12), 0.0)
        splat = splat.at[pix_p[..., 1], pix_p[..., 0]].add(rgb_p * w_prop[..., None])
        splat = splat.at[pix[..., 1], pix[..., 0]].add(rgb * w_cur[..., None])
        state = (jnp.where(accept[..., None], u_prop, u), jnp.where(accept[..., None], rgb_p, rgb),
                 jnp.where(accept, lum_p, lum), jnp.where(accept[..., None], pix_p, pix))
        steps.append((jax.device_get(state), np.asarray(accept)))
    image = np.asarray(splat * (float(b) * 256 / (CHAINS * STEPS)))
    tscene = lt.Scene.from_dict(d)
    return {"b": float(b), "u0": np.asarray(u0), "steps": steps, "image": image,
            "tscene": tscene, "tcomp": lt.compile_scene(tscene, device="cpu")}


def _port_chains(case):
    ti, tcomp = case["tscene"].integrator, case["tcomp"]
    cam = case["tscene"].cameras[0]
    sampler = pssmlt.PSSSampler(ti.dims() - 2)
    b, u0 = ti.bootstrap_chains(tcomp, cam, sampler)
    state = (u0, *ti.trace(tcomp, cam, sampler, u0))
    return ti, tcomp, cam, sampler, float(b), state


def test_bootstrap_matches_reference(chains):
    ti, _, _, _, b, state = _port_chains(chains)
    assert ti.bootstrap // ti.chains == 2
    assert b > 0.0 and abs(b / chains["b"] - 1.0) < 1e-5
    np.testing.assert_array_equal(state[0].numpy(), chains["u0"])


def test_chain_states_match_reference(chains):
    ti, tcomp, cam, sampler, _, state = _port_chains(chains)
    splat = torch.zeros((16, 16, 3))
    flips = []
    for m, ((u_ref, _, lum_ref, pix_ref), acc_ref) in enumerate(chains["steps"]):
        prev_u = state[0]
        splat, state = ti.mutate_step(tcomp, cam, sampler, splat, state,
                                      pssmlt.MUTATION_SALT + m)
        u, _, lum, pix = (x.numpy() for x in state)
        accepted = ~(state[0] == prev_u).all(dim=-1).numpy()
        # equal: u within a float32 step near 1 (dv's last bit, (b)), the
        # luminance within 1e-4, the pixel
        same = ((np.abs(u - u_ref) <= 2.0 ** -23).all(axis=1)
                & np.isclose(lum, lum_ref, rtol=1e-4, atol=1e-7)
                & (pix == pix_ref).all(axis=1))
        assert same.mean() >= 0.999, (m, same.mean())
        flips.append(float((accepted != acc_ref).mean()))
        assert flips[-1] <= 0.001, (m, flips)
        assert 0.05 < acc_ref.mean() < 0.95
    image = (splat * (chains["b"] * 256 / (ti.chains * STEPS))).numpy()
    assert (np.abs(image - chains["image"]).max(-1) > 1e-3).mean() < 0.02
    assert abs(image.mean() / chains["image"].mean() - 1.0) < 0.005


# ---------------------------------------------------------------------------
# (d) the fork, (e) the golden
# ---------------------------------------------------------------------------


def test_render_never_takes_the_fused_fork(monkeypatch):
    from luisarender_tpu_torch.ops import fused_path

    def refuse(*args, **kw):
        raise AssertionError("a PSSMLT path reached the fused fork")

    for name in ("trace_paths_fused_camgen", "trace_paths_fused"):
        monkeypatch.setattr(fused_path, name, refuse)
    scene = lt.Scene.from_dict(_scene(8, 4, CHAINS // 4))
    comp = lt.compile_scene(scene, device="cpu")
    assert comp.plan.fused_path  # the Cornell box would take it on megapath
    img = scene.integrator.render(comp)["cornell.exr"]
    assert np.isfinite(img).all() and img.mean() > 0.0
    # one bootstrap round, the first states and one mutation
    assert scene.integrator.mutations_run == 1
    assert scene.integrator.paths_traced == 3 * CHAINS


def test_render_matches_golden():
    scene = lt.Scene.from_dict(_scene(32, 4, 4 * CHAINS))
    img = lt.render(scene, device="cpu")["cornell.exr"]
    assert scene.integrator.mutations_run == STEPS
    ref = imageio.load_exr(str(GOLDEN))
    assert img.shape == ref.shape == (32, 32, 3) and np.isfinite(img).all()
    assert (np.abs(img - ref).max(-1) > 1e-3).mean() < 0.02
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005
