"""The port's environments (luisarender_tpu_torch/environments), the light
sampler's environment pseudo-light and the fused kernel's environment mode,
against the JAX package, on the CPU.

Inputs are made from numpy seeds. Environment evaluation and sampling are
held within rtol 1e-5 / atol 1e-6: XLA and PyTorch round arccos, atan2,
sin and cos differently by an ulp or two. The alias tables and the
candidates' pdf and radiance are held exactly; the candidates' directions
within 1e-6 (they come from cos and sin). Whole paths are held by the
reference's rule for its fused kernel against its bounce loop
(tests/test_fused_path.py:108-110): ray counts within 4 and under 2% of
pixels off by more than 1e-3. The reference's fused kernel in interpret
mode is not run here (22 s a case); its general fork is held against the
port's forks in tests/test_torch_render.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu import testing as jtesting
from luisarender_tpu.core import sampling as jsampling
from luisarender_tpu.ops import fused_path as jfused
from luisarender_tpu_torch import convert
from luisarender_tpu_torch.core import sampling as tsampling
from luisarender_tpu_torch.integrators.mega_path import (
    general_path_trace_batch, path_trace_batch, pixel_grid,
)
from luisarender_tpu_torch.ops import fused_path as tfused
from luisarender_tpu_torch.utils.imageio import save_exr

import torch_parity  # noqa: F401  (one torch thread)

RES, DEPTH = 16, 3
KW = dict(max_depth=DEPTH, rr_depth=0, rr_threshold=0.95)


def _const(v):
    return {"impl": "constant", "prop": {"v": v}}


SPHERICAL = {"impl": "spherical", "prop": {"emission": _const([0.4, 0.5, 0.7])}}
DIRECTIONAL = {"impl": "directional", "prop": {
    "emission": _const([3.0, 2.5, 2.0]), "direction": [0.3, 1.0, -0.2], "angle": 25.0}}
ENVS = {
    "spherical": SPHERICAL,
    "spherical_rotated": {"impl": "spherical", "prop": {
        "emission": _const([1.0, 0.8, 0.6]), "scale": 1.5,
        "transform": {"impl": "srt", "prop": {"rotate": [0.0, 1.0, 0.0, 40.0]}}}},
    "directional": DIRECTIONAL,
    "combined": {"impl": "combined", "prop": {
        "environments": [SPHERICAL, DIRECTIONAL], "weights": [0.3, 0.7]}},
}


def _scene(env, res=RES, depth=DEPTH, spp=1, lights=True):
    d = jtesting.cornell_box(resolution=(res, res), spp=spp, depth=depth)
    if not lights:
        d["render"]["shapes"] = [s for s in d["render"]["shapes"]
                                 if "light" not in s.get("prop", {})]
    d["render"]["environment"] = env
    return d


def _compile_both(d):
    jscene = lr.Scene.from_dict(d)
    tscene = lt.Scene.from_dict(d)
    return jscene, lr.compile_scene(jscene), tscene, lt.compile_scene(tscene, device="cpu")


def _frac_off(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) > 1e-3).mean())


def _grid(h=8, w=16, seed=3):
    rs = np.random.default_rng(seed)
    img = (rs.uniform(0.05, 1.0, (h, w, 3)) ** 2).astype(np.float32)
    img[2, 5] = [25.0, 20.0, 5.0]
    return img


@pytest.mark.parametrize("name", [*ENVS, "spherical_alias"])
def test_environment_evaluate_and_sample_match_reference(name, tmp_path):
    env = ENVS[name] if name in ENVS else None
    if name == "spherical_alias":
        # a non-constant map, an EXR image texture rasterized by both
        # packages: the alias tables, the bilinear lookup and the texel pdf
        save_exr(tmp_path / "grid.exr", _grid())
        env = {"impl": "spherical", "prop": {"emission": {
            "impl": "image", "prop": {"file": str(tmp_path / "grid.exr")}}}}
    jscene, jcomp, tscene, tcomp = _compile_both(_scene(env))
    jenv, tenv = jscene.environment, tscene.environment
    if name == "spherical_alias":
        assert not jenv.constant and not tenv.constant
    n = 2048
    rs = np.random.default_rng(11)
    wi = rs.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    u = rs.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    ctx = jcomp.context()
    jswl = jcomp.spectrum.sample_wavelengths(jnp.zeros((n, 1), jnp.float32))
    tswl = tcomp.spectrum.sample_wavelengths(torch.zeros((n, 1)))
    tol = dict(rtol=1e-5, atol=1e-6)
    s_ref = jenv.sample(ctx, jnp.zeros((n, 3)), jnp.asarray(u), jswl)
    s = tenv.sample(tcomp, torch.zeros((n, 3)), torch.as_tensor(u), tswl)
    for k in ("wi", "L", "pdf"):
        np.testing.assert_allclose(s[k].numpy(), np.asarray(s_ref[k]), err_msg=k, **tol)
    # evaluate at random directions and at the sampled ones (inside a
    # directional cone)
    for dirs in (wi, np.array(s_ref["wi"])):
        e_ref = jenv.evaluate(ctx, jnp.asarray(dirs), jswl)
        e = tenv.evaluate(tcomp, torch.as_tensor(dirs), tswl)
        for k in ("L", "pdf"):
            np.testing.assert_allclose(e[k].numpy(), np.asarray(e_ref[k]), err_msg=k, **tol)
    assert float(e["pdf"].min()) > 0.0 and float(e["L"].max()) > 0.0


def test_alias_table_2d_matches_reference():
    w = _grid(16, 32, seed=5).sum(-1) * np.sin((np.arange(16) + 0.5) / 16 * np.pi)[:, None]
    ref = jsampling.build_alias_table_2d(w)
    got = tsampling.build_alias_table_2d(w)
    for a, b in ((got.marginal.prob, ref.marginal.prob), (got.marginal.alias, ref.marginal.alias),
                 (got.marginal.pdf, ref.marginal.pdf), (got.cond_prob, ref.cond_prob),
                 (got.cond_alias, ref.cond_alias), (got.cond_pdf, ref.cond_pdf)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    u = np.random.default_rng(2).uniform(0.0, 1.0, (4096, 2)).astype(np.float32)
    x_r, y_r, p_r = jsampling.alias_sample_2d(ref, jnp.asarray(u))
    x, y, p = tsampling.alias_sample_2d(
        *(torch.as_tensor(np.asarray(a)) for a in (
            got.marginal.prob, got.marginal.alias, got.marginal.pdf,
            got.cond_prob, got.cond_alias, got.cond_pdf)), torch.as_tensor(u))
    for a, b in ((x, x_r), (y, y_r), (p, p_r)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _ref_candidates(jcomp, jscene, cam, pxy, sample_index, depth, p_env):
    """The reference's candidates at the same pixels and sample index, its
    seed and two camera draws first (fused_path.py:1734-1750)."""
    px = jnp.asarray(pxy[:, 0])
    py = jnp.asarray(pxy[:, 1])
    si = jnp.zeros_like(px) + sample_index
    u32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint32)  # noqa: E731
    st = jfused._xxhash32_4(u32(si), u32(px), u32(py), jnp.uint32(cam["sampler_seed"]))
    st, _ = jfused._lcg(st)
    st, _ = jfused._lcg(st)
    out = jfused._env_nee_candidates(jcomp, jcomp.arrays, st, pxy.shape[0], depth, p_env)
    return np.stack([np.asarray(c) for c in out]).reshape(depth, 7, -1)


@pytest.mark.parametrize("name", ["spherical", "directional", "env_only"])
def test_candidates_match_reference(name):
    env = SPHERICAL if name != "directional" else DIRECTIONAL
    jscene, jcomp, tscene, tcomp = _compile_both(_scene(env, lights=name != "env_only"))
    p_env = tscene.integrator.light_sampler.selection_probs(tcomp)[0]
    assert p_env == jfused._selection_p_env(jcomp, jscene.integrator.light_sampler)
    assert p_env == (1.0 if name == "env_only" else 0.5)
    cam = tfused.camgen_params(tscene.cameras[0], tscene.integrator.sampler.seed)
    pxy = pixel_grid(RES, RES, "cpu")
    got = tfused.env_nee_candidates(tcomp, cam, pxy, 5, 4, p_env).numpy()
    ref = _ref_candidates(jcomp, jscene, cam, pxy.numpy(), 5, 4, p_env)
    np.testing.assert_array_equal(got[:, 3:], ref[:, 3:])  # pdf * p_env, L
    np.testing.assert_allclose(got[:, :3], ref[:, :3], rtol=0, atol=1e-6)  # wi


def test_fused_env_mode_matches_general_fork():
    """The port's fused fork in its environment mode against its general
    fork, two samples, by the reference's rule; on the reference's tables
    (convert.py) the fused fork gives the port's own image bit for bit.
    The reference's general fork is held against both in
    tests/test_torch_render.py (test_env_cornell_matches_reference)."""
    d = _scene(SPHERICAL)
    jscene, jcomp, tscene, tcomp = _compile_both(d)
    assert jcomp.plan.fused_path and tcomp.plan.fused_path
    integ, camera = tscene.integrator, tscene.cameras[0]
    pxy = pixel_grid(RES, RES, "cpu")
    conv = convert.convert(
        jax.device_get(jcomp.arrays), [c.impl_names[0] for c in jcomp.plan.surface_types],
        [c.impl_names[0] for c in jcomp.plan.light_types], tscene, device="cpu",
        texture_types=[c.impl_names[0] for c in jcomp.plan.texture_types],
        env_distance=jcomp.plan.env_distance)
    assert conv.plan.has_environment and conv.plan.env_distance == tcomp.plan.env_distance
    assert conv.scene.environment.constant == jscene.environment.constant
    for si in range(2):
        args = (camera, integ.sampler, integ.light_sampler, pxy, si)
        rgb_f, _, st_f = path_trace_batch(tcomp, *args, with_stats=True, **KW)
        rgb_c, _, st_c = path_trace_batch(conv, *args, with_stats=True, **KW)
        rgb_g, _, st_g = general_path_trace_batch(tcomp, *args, **KW)
        assert st_f["fused"] == 1 and st_c["fused"] == 1
        assert torch.equal(rgb_f, rgb_c) and int(st_f["rays"]) == int(st_c["rays"])
        assert abs(int(st_f["rays"]) - int(st_g["rays"])) <= 4
        assert _frac_off(rgb_f.numpy(), rgb_g.numpy()) < 0.02
        assert float(rgb_f.mean()) > 0.0


def test_escape_state_and_miss_pass():
    """The plain version's escape words: a path that escaped keeps its
    throughput, pdf and direction; the others read 0 and (0, 0, 1). The
    miss pass adds nothing where no path escaped."""
    jscene, jcomp, tscene, tcomp = _compile_both(_scene(SPHERICAL))
    t = tfused.fused_tables(tcomp)
    cam = tfused.camgen_params(tscene.cameras[0], tscene.integrator.sampler.seed)
    pxy = pixel_grid(RES, RES, "cpu")
    env = tfused.EnvInputs(tfused.env_nee_candidates(tcomp, cam, pxy, 0, DEPTH, 0.5),
                           0.5, tcomp.plan.env_distance)
    rgb, rays, esc = tfused.paths(t, cam, pxy, 0, 0, env=env, **KW)
    escaped = esc[3] > 0.0
    assert 0 < int(escaped.sum()) < pxy.shape[0]
    assert torch.all(esc[:, ~escaped] == torch.tensor([0.0] * 6 + [1.0])[:, None])
    assert torch.allclose(esc[4:7, escaped].norm(dim=0), torch.ones(()), atol=1e-5)
    out = tfused.miss_pass(tcomp, rgb, esc, 0.5)
    assert torch.equal(out[~escaped], rgb[~escaped])
    assert bool((out[escaped] > rgb[escaped]).all())
    # without the environment's inputs the kernel's plain version refuses
    with pytest.raises(ValueError):
        tfused.paths(t, cam, pxy, 0, 2, env=env, **KW)


@pytest.mark.parametrize("name,fused", [
    ("spherical", True), ("directional", True), ("combined", False), ("checkerboard", False),
])
def test_fused_eligibility_with_environments(name, fused):
    env = ENVS["spherical"] if name == "checkerboard" else ENVS[name]
    d = _scene(env)
    if name == "checkerboard":
        d["render"]["shapes"][0]["prop"]["surface"] = {"impl": "matte", "prop": {"Kd": {
            "impl": "checkerboard", "prop": {"on": _const([0.9, 0.9, 0.9]),
                                             "off": _const([0.1, 0.1, 0.1])}}}}
    jscene, jcomp, tscene, tcomp = _compile_both(d)
    assert jcomp.plan.fused_path == fused and tcomp.plan.fused_path == fused
    assert tcomp.plan.has_environment and tcomp.plan.env_distance == jcomp.plan.env_distance


def test_megawave_env_scene_takes_the_per_pass_route():
    d = _scene(SPHERICAL, res=8, depth=2, spp=4)
    d["render"]["integrator"]["impl"] = "megawave"
    scene = lt.Scene.from_dict(d)
    img = lt.render(scene, device="cpu")["cornell.exr"]
    assert np.isfinite(img).all() and img.mean() > 0.0
    # one megapath launch a sample, none persistent
    assert scene.integrator.fused_passes == 4 and scene.integrator.bounces_run == 0
    comp = lt.compile_scene(scene, device="cpu")
    cam = tfused.camgen_params(scene.cameras[0], scene.integrator.sampler.seed)
    with pytest.raises(ValueError, match="environment"):
        tfused.trace_paths_fused_persistent(comp, cam, pixel_grid(8, 8, "cpu"), 0, 2, **KW)


def test_white_furnace():
    """tests/test_environment.py:44-57 on the port, cut to 16^2, 16 spp,
    depth 8: a unit-albedo analytic sphere in a unit constant environment
    vanishes into it, every pixel near 1 (the environment's NEE pdfs, the
    miss pass and MIS together). The scene takes the fused fork."""
    d = {"render": {
        "cameras": [{"impl": "pinhole", "prop": {
            "fov": 30.0, "spp": 16, "file": "env.exr",
            "film": {"impl": "color", "prop": {"resolution": [16, 16]}},
            "transform": {"impl": "view", "prop": {"origin": [0, 0, 4], "front": [0, 0, -1]}}}}],
        "integrator": {"impl": "megapath", "prop": {"depth": 8}},
        "environment": {"impl": "spherical", "prop": {"emission": _const([1.0, 1.0, 1.0])}},
        "shapes": [{"impl": "sphere", "prop": {"subdivision": 3, "surface": {
            "impl": "matte", "prop": {"Kd": _const([1.0, 1.0, 1.0])}}}}],
    }}
    scene = lt.Scene.from_dict(d)
    img = lt.render(scene, device="cpu")["env.exr"]
    assert scene.integrator.fused_passes == 16
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), 1.0, atol=0.02)
    assert np.abs(img - 1.0).max() < 0.25
