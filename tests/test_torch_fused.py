"""The fused whole-path kernel's plain version (luisarender_tpu_torch/ops/
fused_path.py) and its routing, against the JAX package, on the CPU.

The JAX kernel runs in interpret mode, as tests/test_fused_path.py runs it.
The plain version repeats the CUDA kernel's arithmetic; the CUDA kernel
itself is held against it on the card (tests/test_torch_kernels_gpu.py).

Where XLA and PyTorch round a transcendental (or XLA contracts a
multiply-add) differently, a path whose discrete choice (Russian roulette,
an occlusion or a lobe pick) sits on the boundary diverges, so whole-path
results are held with the reference's own rule for its fused kernel
against its bounce loop (tests/test_fused_path.py:108-110): ray counts
within 4 and under 2% of lanes off by more than 1e-3.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu import testing as jtesting
from luisarender_tpu.ops import fused_path as jfused
from luisarender_tpu_torch import convert, testing
from luisarender_tpu_torch.integrators.mega_path import (
    general_path_trace_batch, path_trace_batch, pixel_grid,
)
from luisarender_tpu_torch.ops import fused_path as tfused

ROOT = Path(__file__).parent.parent
RES, DEPTH = 16, 3
KW = dict(max_depth=DEPTH, rr_depth=0, rr_threshold=0.95)


def _const(v):
    return {"impl": "constant", "prop": {"v": v}}


# single-type Cornell boxes (tests/test_fused_path.py:79-91) and the
# eligibility cases of tests/test_fused_path.py:45-78
SINGLE = {
    "mirror": {"impl": "mirror", "prop": {"roughness": _const([0.2])}},
    "metal": {"impl": "metal", "prop": {"eta": "Au", "roughness": _const([0.3])}},
    "plastic": {"impl": "plastic", "prop": {}},
    "glass": {"impl": "glass", "prop": {"material": "bk7"}},
    "disney": {"impl": "disney", "prop": {"metallic": _const([0.8]),
                                          "roughness": _const([0.25])}},
}


def _scene(name, res=RES, depth=DEPTH):
    if name == "materials":
        d = json.load(open(ROOT / "scenes" / "materials.json"))
        d["render"]["cameras"][0]["prop"]["film"]["prop"]["resolution"] = [res, res]
        d["render"]["integrator"]["prop"]["depth"] = depth
        return d
    d = jtesting.cornell_box(resolution=(res, res), spp=1, depth=depth)
    if name in SINGLE:
        for shape in d["render"]["shapes"]:
            shape["prop"]["surface"] = SINGLE[name]
    elif name == "disney_transmissive":
        d["render"]["shapes"][0]["prop"]["surface"] = {
            "impl": "disney", "prop": {"specular_trans": _const([0.5])}}
    elif name == "reflective_disney_floor":
        d["render"]["shapes"][0]["prop"]["surface"] = SINGLE["disney"]
    return d


@pytest.mark.parametrize("name", ["cornell", "materials", *SINGLE,
                                  "disney_transmissive", "reflective_disney_floor"])
def test_pack_and_eligibility_match_reference(name):
    d = _scene(name)
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    tcomp = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    assert tcomp.plan.fused_path == jcomp.plan.fused_path
    assert tcomp.plan.fused_path == (name != "disney_transmissive")
    if not jcomp.plan.fused_path:
        assert "fused" not in tcomp.arrays
        return
    for k in ("inst_table", "entry_table"):
        np.testing.assert_allclose(
            tcomp.arrays["fused"][k].numpy(), np.asarray(jcomp.arrays["fused"][k]),
            rtol=0, atol=1e-7, err_msg=k)


def _jax_fused(name):
    jscene = lr.Scene.from_dict(_scene(name))
    jcomp = lr.compile_scene(jscene)
    cam = jfused.camgen_params(jscene.cameras[0], 0.0)
    cam = {**cam, "sampler_seed": jscene.integrator.sampler.seed & 0xFFFFFFFF}
    pxy = pixel_grid(RES, RES, "cpu").numpy()
    rgb, rays = jfused.trace_paths_fused_camgen(
        jcomp, jcomp.arrays, cam, jnp.asarray(pxy), jnp.int32(0), interpret=True, **KW)
    return jcomp, np.asarray(rgb), int(rays)


def _frac_off(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) > 1e-3).mean())


@pytest.mark.parametrize("name", ["cornell", "materials"])
def test_plain_version_matches_reference_kernel(name):
    jcomp, rgb_ref, rays_ref = _jax_fused(name)
    tscene = lt.Scene.from_dict(_scene(name))
    own = lt.compile_scene(tscene, device="cpu")
    conv = convert.convert(
        jax.device_get(jcomp.arrays), [c.impl_names[0] for c in jcomp.plan.surface_types],
        [c.impl_names[0] for c in jcomp.plan.light_types], tscene, device="cpu")
    cam = tfused.camgen_params(tscene.cameras[0], tscene.integrator.sampler.seed)
    pxy = pixel_grid(RES, RES, "cpu")
    # the reference's own tables (its triangle order), then the port's
    for comp in (conv, own):
        assert tfused.use_fused(comp, tscene.integrator.sampler, tscene.integrator.light_sampler)
        rgb, rays = tfused.trace_paths_fused_camgen(comp, cam, pxy, 0, **KW)
        assert abs(int(rays) - rays_ref) <= 4
        assert _frac_off(rgb.numpy(), rgb_ref) < 0.02
    assert rgb_ref.mean() > 0.0


def test_persistent_equals_sum_of_samples():
    d = _scene("materials")
    scene = lt.Scene.from_dict(d)
    comp = lt.compile_scene(scene, device="cpu")
    cam = tfused.camgen_params(scene.cameras[0], scene.integrator.sampler.seed)
    pxy = pixel_grid(RES, RES, "cpu")
    tot, rays = 0.0, 0
    for s in range(4):
        rgb, r = tfused.trace_paths_fused_camgen(comp, cam, pxy, s, **KW)
        tot, rays = tot + rgb, rays + int(r)
    rgb_p, rays_p = tfused.trace_paths_fused_persistent(comp, cam, pxy, 0, 4, **KW)
    np.testing.assert_allclose(rgb_p.numpy(), tot.numpy(), atol=1e-6)
    assert int(rays_p) == rays


def test_fused_fork_matches_general_fork():
    """tests/test_fused_path.py:143-174 on the port: the fused fork against
    the port's own bounce loop, two samples."""
    scene = lt.Scene.from_dict(_scene("cornell"))
    comp = lt.compile_scene(scene, device="cpu")
    integ, camera = scene.integrator, scene.cameras[0]
    pxy = pixel_grid(RES, RES, "cpu")
    acc_f, acc_g, rays_f, rays_g = 0.0, 0.0, 0, 0
    for si in range(2):
        rgb, _, st = path_trace_batch(comp, camera, integ.sampler, integ.light_sampler,
                                      pxy, si, with_stats=True, **KW)
        assert st["fused"] == 1 and st["bounces"] == 0
        acc_f, rays_f = acc_f + rgb.numpy(), rays_f + int(st["rays"])
        rgb, _, st = general_path_trace_batch(comp, camera, integ.sampler,
                                              integ.light_sampler, pxy, si, **KW)
        acc_g, rays_g = acc_g + rgb.numpy(), rays_g + int(st["rays"])
    assert abs(rays_f - rays_g) <= max(8, rays_g // 500)
    assert _frac_off(acc_f / 2, acc_g / 2) < 0.02
    assert abs(acc_f.mean() - acc_g.mean()) < 0.02 * acc_g.mean()


def test_megawave_matches_megapath():
    imgs = {}
    for integrator in ("megawave", "megapath"):
        scene = lt.Scene.from_dict(testing.cornell_box(
            resolution=(RES, RES), spp=8, depth=DEPTH, integrator=integrator))
        imgs[integrator] = lt.render(scene, device="cpu")["cornell.exr"]
        # samples_per_pass = 4: two persistent passes, or one pass a sample
        assert scene.integrator.fused_passes == (2 if integrator == "megawave" else 8)
        assert scene.integrator.bounces_run == 0
    np.testing.assert_allclose(imgs["megawave"], imgs["megapath"], atol=1e-5)


def test_opt_out_takes_the_general_fork(monkeypatch):
    scene = lt.Scene.from_dict(testing.cornell_box(resolution=(8, 8), spp=1, depth=2))
    monkeypatch.setenv("LUISARENDER_TPU_NO_FUSED", "1")
    lt.render(scene, device="cpu")
    assert scene.integrator.fused_passes == 0 and scene.integrator.bounces_run >= 1


@pytest.mark.parametrize("n_samples", [0, 3], ids=["megapath", "persistent"])
@pytest.mark.parametrize("name", ["cornell", "materials"])
def test_plain_lanes_do_not_depend_on_order_or_count(name, n_samples):
    """The contract the kernel's scheduler relies on: a pixel's rgb and ray
    count depend on the pixel alone, not on which lanes run beside it or in
    what order, so lanes may be taken from a work counter, regrouped by
    surface type and retired in any order. The plain version on a permuted
    pixel list and on ragged subsets gives the permuted or subset rows of
    the run over the whole grid, bit for bit."""
    scene = lt.Scene.from_dict(_scene(name))
    tables = tfused.fused_tables(lt.compile_scene(scene, device="cpu"))
    cam = tfused.camgen_params(scene.cameras[0], scene.integrator.sampler.seed)
    pxy = pixel_grid(RES, RES, "cpu")
    rgb, rays = tfused.paths_plain(tables, cam, pxy, 2, n_samples, **KW)
    assert rgb.abs().sum() > 0.0
    rs = np.random.RandomState(7)
    for idx in (rs.permutation(pxy.shape[0]), *(rs.choice(pxy.shape[0], k, replace=False)
                                                for k in (1, 37, 129))):
        idx = torch.as_tensor(idx)
        rgb_i, rays_i = tfused.paths_plain(tables, cam, pxy[idx].contiguous(), 2, n_samples, **KW)
        assert torch.equal(rgb_i, rgb[idx]) and torch.equal(rays_i, rays[idx])
