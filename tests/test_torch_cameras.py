"""The port's cameras, filters and clip planes (thinlens, ortho, the LUT
filters) and the fused kernel's ray-input mode that renders them, against
the JAX package, on the CPU.

Inputs are made from numpy seeds. Each filter's LUT and its alias table's
sampling are held within atol 1e-6 (the LUT is built by the same float64
code; the draws differ from XLA's by a rounding at most), each camera's
rays, weights and clip-plane t range within rtol 1e-6 / atol 1e-4 (world
units of ~500 put an ulp of an origin at ~3e-5). The ray-input plain
version fed the in-kernel camera's own rays and states is held bit for bit
against the camgen plain version. Whole paths are held by the reference's
rule for its fused kernel against its bounce loop (tests/test_fused_path.py:
108-110): ray counts within 4 and under 2% of pixels off by more than 1e-3,
against the reference's general fork at 16^2, depth 3; its fused kernel in
interpret mode is not run (22 s a case).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu import testing as jtesting
from luisarender_tpu.integrators.mega_path import path_trace_batch as jax_ptb
from luisarender_tpu_torch.core.types import make_ray
from luisarender_tpu_torch.integrators import mega_path as tmega
from luisarender_tpu_torch.integrators.mega_path import (
    general_path_trace_batch, path_trace_batch, pixel_grid,
)
from luisarender_tpu_torch.ops import fused_path as tfused

import torch_parity  # noqa: F401  (one torch thread)

RES, DEPTH = 16, 3
KW = dict(max_depth=DEPTH, rr_depth=0, rr_threshold=0.95)
CORNELL = Path(__file__).parent.parent / "scenes" / "cornell.json"

THINLENS = {"focal_length": 33.6, "focus_position": [278.0, 273.0, 279.6], "aperture": 0.005}
ORTHO = {"zoom": -8.1}
CAMERAS = {
    "pinhole": ("pinhole", {"fov": 39.3077}),
    "pinhole_clip_pair": ("pinhole", {"fov": 39.3077, "clip": [1500.0, 1000.0]}),
    "pinhole_clip_plane": ("pinhole", {"fov": 39.3077, "clip_plane": 900.0}),
    "thinlens": ("thinlens", THINLENS),
    "thinlens_clip": ("thinlens", {**THINLENS, "clip": [1000.0, 1400.0]}),
    "thinlens_portrait": ("thinlens", {**THINLENS, "focus_distance": 900.0,
                                       "focus_position": None}),
    "ortho": ("ortho", ORTHO),
    "ortho_clip": ("ortho", {**ORTHO, "clip_plane": 1000.0}),
}
FILTERS = {
    "box": {},
    "triangle": {},
    "gaussian": {"sigma": 0.4, "radius": 1.5},
    "mitchell": {},
    "lanczos": {"tau": 2.0},
}


def _cornell(camera="pinhole", cam_props=None, filt="box", filt_props=None, res=(RES, RES),
             spp=1, depth=DEPTH, integrator=None, env=None):
    d = jtesting.cornell_box(resolution=res, spp=spp, depth=depth, integrator=integrator)
    c = d["render"]["cameras"][0]
    c["impl"] = camera
    if camera != "pinhole":
        c["prop"].pop("fov")
    c["prop"].update({k: v for k, v in (cam_props or {}).items() if v is not None})
    c["prop"]["filter"] = {"impl": filt, "prop": dict(filt_props or {})}
    if env is not None:
        d["render"]["environment"] = {"impl": "spherical", "prop": {
            "emission": {"impl": "constant", "prop": {"v": env}}}}
    return d


def _frac_off(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) > 1e-3).mean())


def _pixels(w, h):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)


@pytest.mark.parametrize("name", FILTERS)
def test_filter_lut_alias_and_sample_match_reference(name):
    d = _cornell(filt=name, filt_props=FILTERS[name])
    jf = lr.Scene.from_dict(d).cameras[0].filter
    tf = lt.Scene.from_dict(d).cameras[0].filter
    assert tf.radius == jf.radius
    np.testing.assert_allclose(tf.lut, np.asarray(jf.lut), atol=1e-6, rtol=0)
    for got, ref in zip(tf.table, jf.table):
        np.testing.assert_array_equal(got, np.asarray(ref))
    u = np.random.default_rng(5).uniform(0.0, 1.0, (RES * RES, 2)).astype(np.float32)
    off_r, w_r = jf.sample(jnp.asarray(u))
    off, w = tf.sample(torch.as_tensor(u))
    np.testing.assert_allclose(off.numpy(), np.asarray(off_r), atol=1e-6, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), atol=1e-6, rtol=1e-6)
    if name in ("mitchell", "lanczos"):
        assert float(w.min()) < 0.0  # negative lobes give negative weights


@pytest.mark.parametrize("name", CAMERAS)
def test_camera_rays_match_reference(name):
    impl, props = CAMERAS[name]
    res = (8, 32) if name.endswith("portrait") else (RES, RES)  # 256 lanes either way
    d = _cornell(impl, props, "gaussian", res=res)
    jcam = lr.Scene.from_dict(d).cameras[0]
    tcam = lt.Scene.from_dict(d).cameras[0]
    assert tcam.clip_plane == jcam.clip_plane
    assert tcam.requires_lens_sampling == jcam.requires_lens_sampling
    rs = np.random.default_rng(9)
    pxy = _pixels(*res)
    u_f = rs.uniform(0.0, 1.0, (pxy.shape[0], 2)).astype(np.float32)
    u_l = rs.uniform(0.0, 1.0, (pxy.shape[0], 2)).astype(np.float32)
    ray_r, pix_r, w_r = jcam.generate_rays(jnp.asarray(pxy), jnp.asarray(u_f),
                                           jnp.asarray(u_l), 0.0)
    ray, pix, w = tcam.generate_rays(torch.as_tensor(pxy), torch.as_tensor(u_f),
                                     torch.as_tensor(u_l))
    tol = dict(rtol=1e-6, atol=1e-4)
    for got, ref, what in ((ray.origin, ray_r.origin, "origin"),
                           (ray.direction, ray_r.direction, "direction"),
                           (ray.t_min, ray_r.t_min, "t_min"), (ray.t_max, ray_r.t_max, "t_max"),
                           (pix, pix_r, "pixel"), (w, w_r, "weight")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=what, **tol)
    if tcam.clip_plane is not None:
        assert float(ray.t_min.min()) > 0.0 and bool(torch.isfinite(ray.t_max).all())


def _camgen_rays(t, cam, pxy, si, max_depth):
    """The in-kernel camera's rays and states, as pack_rays lanes."""
    pl = tfused._Plain(t, cam, pxy, max_depth, 0, 0.95)
    st, o, d = pl.gen_from_cam(torch.full((pxy.shape[0],), si, dtype=torch.int64))
    ray = make_ray(torch.stack(o, -1), torch.stack(d, -1), 0.0, float("inf"))
    return st, tfused.pack_rays(ray, torch.ones(pxy.shape[0]), st)


@pytest.mark.parametrize("env", [None, [0.4, 0.5, 0.7]], ids=["cornell_json", "env"])
def test_ray_input_plain_equals_camgen_plain(env):
    """The ray-input mode fed the camgen mode's own rays and states renders
    the camgen mode's paths bit for bit: rgb, ray counts and, with an
    environment, the candidates (from the given states) and escape words."""
    if env is None:
        d = json.loads(CORNELL.read_text())
        d["render"]["cameras"][0]["prop"]["film"]["prop"]["resolution"] = [RES, RES]
    else:
        d = _cornell(env=env)
    scene = lt.Scene.from_dict(d)
    comp = lt.compile_scene(scene, device="cpu")
    t = tfused.fused_tables(comp)
    cam = tfused.camgen_params(scene.cameras[0], scene.integrator.sampler.seed)
    pxy = pixel_grid(RES, RES, "cpu")
    kw = dict(max_depth=4, rr_depth=0, rr_threshold=0.95)
    st, rays = _camgen_rays(t, cam, pxy, 3, 4)
    envs = [None, None]
    if env is not None:
        p_env = scene.integrator.light_sampler.selection_probs(comp)[0]
        cand = tfused.env_nee_candidates(comp, cam, pxy, 3, 4, p_env)
        cand_r = tfused.env_nee_candidates_from_state(comp, st, 4, p_env)
        assert torch.equal(cand, cand_r)
        envs = [tfused.EnvInputs(c, p_env, comp.plan.env_distance) for c in (cand, cand_r)]
    out_c = tfused.paths(t, cam, pxy, 3, 0, env=envs[0], **kw)
    out_r = tfused.paths_rays(t, rays, env=envs[1], **kw)
    assert len(out_c) == len(out_r) == (2 if env is None else 3)
    for a, b in zip(out_c, out_r):
        assert torch.equal(a, b)
    assert float(out_c[0].mean()) > 0.0


def test_ray_input_first_bounce_takes_the_given_t_range():
    """A lane whose t range excludes every hit escapes at once; a t_min past
    the first hit moves the hit behind it; the camera weight scales the
    radiance."""
    d = json.loads(CORNELL.read_text())
    scene = lt.Scene.from_dict(d)
    comp = lt.compile_scene(scene, device="cpu")
    t = tfused.fused_tables(comp)
    cam = tfused.camgen_params(scene.cameras[0], scene.integrator.sampler.seed)
    pxy = torch.tensor([[256, 256]] * 4, dtype=torch.int32)
    st, rays = _camgen_rays(t, cam, pxy, 0, 3)
    rays[7, 0] = 1.0  # t_max before the box
    rays[6, 1] = 1200.0  # t_min inside it: the back wall's hit stays
    rays[6, 2] = 5000.0  # t_min past it: nothing left
    rays[8, 3] = 2.0  # a camera weight: every product doubles exactly
    kw = dict(max_depth=3, rr_depth=10, rr_threshold=0.95)  # no roulette
    rgb, n = tfused.paths_rays(t, rays, **kw)
    base, n0 = tfused.paths_rays(t, _camgen_rays(t, cam, pxy, 0, 3)[1], **kw)
    assert int(n[0]) == 1 and float(rgb[0].abs().max()) == 0.0
    assert int(n[2]) == 1 and float(rgb[2].abs().max()) == 0.0
    assert int(n[1]) >= 1
    assert torch.equal(rgb[3], base[3] * 2.0) and int(n[3]) == int(n0[3])


PATH_CASES = {
    "thinlens_gaussian": dict(camera="thinlens", cam_props=THINLENS, filt="gaussian"),
    "ortho_lanczos": dict(camera="ortho", cam_props=ORTHO, filt="lanczos"),
    "pinhole_mitchell_clip": dict(camera="pinhole", cam_props={"fov": 39.3077,
                                                               "clip": [1000.0, 1e10]},
                                  filt="mitchell"),
    "thinlens_env": dict(camera="thinlens", cam_props=THINLENS, filt="gaussian",
                         env=[0.4, 0.5, 0.7]),
}


@pytest.mark.parametrize("name", PATH_CASES)
def test_path_trace_batch_matches_reference(name):
    """The port's fused fork (the ray-input plain version) and general fork
    against the reference's path_trace_batch (its CPU run takes its general
    fork), one sample at 16^2, depth 3, by the reference's rule."""
    d = _cornell(**PATH_CASES[name])
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    pxy = _pixels(RES, RES)
    rgb_ref, _, st_ref = jax_ptb(
        jcomp, jcomp.arrays, jscene.cameras[0], jscene.integrator.sampler,
        jscene.integrator.light_sampler, jnp.asarray(pxy), jnp.int32(1),
        with_stats=True, **KW)
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    assert tcomp.plan.fused_path
    assert tfused.camgen_params(tscene.cameras[0], tscene.integrator.sampler.seed) is None
    args = (tcomp, tscene.cameras[0], tscene.integrator.sampler,
            tscene.integrator.light_sampler, torch.as_tensor(pxy), 1)
    rgb_f, _, st_f = path_trace_batch(*args, with_stats=True, **KW)
    rgb_g, _, st_g = general_path_trace_batch(*args, **KW)
    assert st_f["fused"] == 1 and st_g["bounces"] >= 1
    for rgb, st in ((rgb_f, st_f), (rgb_g, st_g)):
        assert abs(int(st["rays"]) - int(st_ref["rays"])) <= 4
        assert _frac_off(rgb.numpy(), np.asarray(rgb_ref)) < 0.02
    assert float(rgb_f.mean()) > 0.0


def test_megawave_renders_ray_input_scenes_a_sample_a_launch(monkeypatch):
    """megawave on a thinlens scene takes the per-sample ray-input route:
    no persistent pass, one ray-input call a sample."""
    calls = {"rays": 0}
    real = tfused.trace_paths_fused

    def count(*a, **k):
        calls["rays"] += 1
        return real(*a, **k)

    def persistent(*a, **k):
        raise AssertionError("a persistent pass on a ray-input scene")

    monkeypatch.setattr(tfused, "trace_paths_fused", count)
    monkeypatch.setattr(tfused, "trace_paths_fused_persistent", persistent)
    scene = lt.Scene.from_dict(_cornell("thinlens", THINLENS, "gaussian", res=(8, 8), spp=3,
                                        integrator="megawave"))
    img = lt.render(scene, device="cpu")["cornell.exr"]
    assert calls["rays"] == 3 and scene.integrator.fused_passes == 3
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0.0
    assert tmega.MegawaveIntegrator.persistent


def test_scenes_load_and_route():
    """Every new camera, filter and clip plane loads; a clipped pinhole and
    any other camera or filter leave the in-kernel camera; a shutter span
    loads with the reference's span and bucket weights."""
    for camera, props in (("thinlens", THINLENS), ("ortho", ORTHO)):
        for filt in FILTERS:
            scene = lt.Scene.from_dict(_cornell(camera, props, filt))
            assert tfused.camgen_params(scene.cameras[0], 0) is None
    scene = lt.Scene.from_dict(_cornell(cam_props={"clip_plane": 10.0}))
    assert scene.cameras[0].clip_plane == (10.0, 1e10)
    assert tfused.camgen_params(scene.cameras[0], 0) is None
    assert tfused.camgen_params(lt.Scene.from_dict(_cornell()).cameras[0], 0) is not None
    shutter = _cornell(cam_props={"shutter_span": [0.0, 1.0], "shutter_samples": 6})
    cam = lt.Scene.from_dict(shutter).cameras[0]
    jcam = lr.Scene.from_dict(shutter).cameras[0]
    assert cam.shutter_span == jcam.shutter_span == (0.0, 1.0) and cam.shutter_samples == 6
    np.testing.assert_array_equal(np.asarray(cam.shutter_weights(6)),
                                  np.asarray(jcam.shutter_weights(6)))
