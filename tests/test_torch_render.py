"""The port's main path as a whole, on testing.cornell_box, on the CPU.

(a) the port's path_trace_batch, which takes the fused fork for the Cornell
    box, and its general fork, against the reference's path_trace_batch,
    whose CPU run takes its general fork (the bounce loop of
    integrators/common.py);
(b) the port's render() against the committed golden images: the Cornell
    box through the fused fork, scenes/materials.json (cut to 48^2, 8 spp,
    depth 5) through the general fork, and the Cornell box with a
    1,280-triangle sphere through the general fork's cluster trace;
(c) the port rendering the reference's tables (convert.py) against the port
    rendering its own compiler's tables: the same tables, the same image;
(d) scenes above 512 triangles, which trace with the cluster kernel (its
    plain version here): the Cornell box with a 1,280-triangle sphere and
    the mesh-heavy scene at test size (its checkerboard floor and
    environment included), sample by sample against the reference's
    path_trace_batch (its CPU run walks its skip-link BVH);
(e) the Cornell box with a constant spherical environment: the port's
    fused fork (its environment mode) and general fork against the
    reference's general fork.

The rule is the reference's own for its fused kernel against its bounce
loop (tests/test_fused_path.py): ray counts within 4, and under 2% of
pixels with a max-channel difference above 1e-3. It needs a tolerance
because the two do not round alike: the reference's CPU trace is XLA's
key-packed brute force (accel/traverse.py), which breaks near-ties in t
differently from the kernel's strict first-lowest rule, XLA contracts
multiply-adds into FMAs and rounds transcendentals (the cosine-hemisphere
warp's cos/sin) differently from PyTorch, and a path whose discrete choice
(hit or miss at an edge, Russian roulette, alias pick) flips on such a
rounding difference diverges from then on.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu import testing as jtesting
from luisarender_tpu.integrators.mega_path import path_trace_batch as jax_ptb
from luisarender_tpu.ops import fused_path
from luisarender_tpu_torch import convert
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.integrators.mega_path import (
    general_path_trace_batch, path_trace_batch,
)
from luisarender_tpu_torch.utils import imageio

from torch_parity import require_reference_builder

GOLDEN = Path(__file__).parent / "golden" / "cornell_64_8spp.exr"
MATERIALS_GOLDEN = Path(__file__).parent / "golden" / "materials_48_8spp.exr"


def _frac_off(a, b):
    return float((np.abs(a - b).max(-1) > 1e-3).mean())


def _pixels(res):
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)


@pytest.mark.parametrize("sample_index", [0, 5])
def test_path_trace_batch_matches_reference(sample_index):
    res, depth = 16, 3
    d = jtesting.cornell_box(resolution=(res, res), spp=1, depth=depth)
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    assert not fused_path.use_fused(
        jcomp, jscene.integrator.sampler, jscene.integrator.light_sampler
    )  # the reference's CPU run takes the general fork
    pxy = _pixels(res)
    rgb_ref, _, st_ref = jax_ptb(
        jcomp, jcomp.arrays, jscene.cameras[0], jscene.integrator.sampler,
        jscene.integrator.light_sampler, jnp.asarray(pxy), jnp.int32(sample_index),
        max_depth=depth, rr_depth=0, rr_threshold=0.95, with_stats=True,
    )
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    args = (tcomp, tscene.cameras[0], tscene.integrator.sampler,
            tscene.integrator.light_sampler, torch.as_tensor(pxy), sample_index)
    kw = dict(max_depth=depth, rr_depth=0, rr_threshold=0.95)
    rgb, weight, st = path_trace_batch(*args, with_stats=True, **kw)
    assert st["fused"] == 1 and st["bounces"] == 0  # the fused fork
    rgb_g, weight_g, st_g = general_path_trace_batch(*args, **kw)
    assert 1 <= st_g["bounces"] <= depth
    for r, w, s in ((rgb, weight, st), (rgb_g, weight_g, st_g)):
        assert r.shape == (res * res, 3) and torch.all(w == 1.0)
        assert abs(int(s["rays"]) - int(st_ref["rays"])) <= 4
        assert _frac_off(r.numpy(), np.asarray(rgb_ref)) < 0.02


def test_render_matches_golden():
    """The golden is the reference's general fork. The port's render takes
    the fused fork, whose paths flip on rounding at a boundary now and
    then; over 8 samples 2.2% of the pixels (0.0225) differ from the golden
    by more than 1e-3. So the image is held by its mean, each sample of the
    fused fork against the general fork with the reference's rule
    (tests/test_fused_path.py:165-174), and the general fork's image
    against the golden with this file's rule."""
    d = testing.cornell_box(resolution=(64, 64), spp=8, depth=5)
    scene = lt.Scene.from_dict(d)
    img = lt.render(scene, device="cpu")["cornell.exr"]
    ref = imageio.load_exr(str(GOLDEN))
    assert img.shape == ref.shape and np.all(np.isfinite(img))
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005
    # one fused launch a sample, no host bounce loop; every ray is counted
    assert scene.integrator.fused_passes == 8 and scene.integrator.bounces_run == 0
    assert scene.integrator.rays_traced > 64 * 64 * 8

    comp = lt.compile_scene(scene, device="cpu")
    integ = scene.integrator
    pxy = torch.as_tensor(_pixels(64))
    kw = dict(max_depth=5, rr_depth=0, rr_threshold=0.95)
    acc = 0.0
    for si in range(8):
        args = (comp, scene.cameras[0], integ.sampler, integ.light_sampler, pxy, si)
        rgb_f, _, st_f = path_trace_batch(*args, with_stats=True, **kw)
        rgb_g, _, st_g = general_path_trace_batch(*args, **kw)
        assert abs(int(st_f["rays"]) - int(st_g["rays"])) <= max(8, int(st_g["rays"]) // 500)
        assert _frac_off(rgb_f.numpy(), rgb_g.numpy()) < 0.02
        acc = acc + rgb_g.numpy()
    img_g = (acc / 8).reshape(64, 64, 3)
    assert _frac_off(img_g, ref) < 0.02


def test_general_fork_matches_materials_golden(monkeypatch):
    """scenes/materials.json (four analytic spheres of glass, metal,
    plastic and disney) cut to 48^2, 8 spp, depth 5: the port's general
    fork against the reference's golden, under this file's rule."""
    import json

    d = json.load(open(Path(__file__).parent.parent / "scenes" / "materials.json"))
    cam = d["render"]["cameras"][0]["prop"]
    cam["film"]["prop"]["resolution"] = [48, 48]
    cam["spp"] = 8
    d["render"]["integrator"]["prop"]["depth"] = 5
    monkeypatch.setenv("LUISARENDER_TPU_NO_FUSED", "1")
    scene = lt.Scene.from_dict(d)
    img = lt.render(scene, device="cpu")["materials.exr"]
    assert scene.integrator.fused_passes == 0 and scene.integrator.bounces_run > 8
    ref = imageio.load_exr(str(MATERIALS_GOLDEN))
    assert img.shape == ref.shape and np.all(np.isfinite(img))
    assert _frac_off(img, ref) < 0.02
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005


def test_converted_tables_render_like_own_compiler():
    """Both compilers sort by the same SAH tree, so the converted tables are
    the port's own and the two renders are the same image."""
    require_reference_builder()
    d = testing.cornell_box(resolution=(32, 32), spp=4, depth=5)
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    scene = lt.Scene.from_dict(d)
    conv = convert.convert(
        jax.device_get(jcomp.arrays),
        [c.impl_names[0] for c in jcomp.plan.surface_types],
        [c.impl_names[0] for c in jcomp.plan.light_types],
        scene, device="cpu",
    )
    own = lt.compile_scene(scene, device="cpu")
    for k, v in own.arrays["trace"].items():
        assert torch.equal(conv.arrays["trace"][k], v), k
    img_conv = scene.integrator.render(conv)["cornell.exr"]
    rays_conv = scene.integrator.rays_traced
    img_own = scene.integrator.render(own)["cornell.exr"]
    assert scene.integrator.rays_traced == rays_conv
    np.testing.assert_array_equal(img_conv, img_own)


@pytest.mark.parametrize("name,res,n_samples,n_tris", [
    ("cornell_sphere", (16, 16), 2, 1312),
    ("mesh_heavy", (16, 9), 1, 1284),
])
def test_cluster_scene_matches_reference(name, res, n_samples, n_tris):
    """Depth 3, each sample by this file's rule. The mesh-heavy scene is
    testing.mesh_heavy(n=2, subdiv=2), the reference's scene at test size:
    four Disney icospheres, the checkerboard floor, the light panel with
    its null surface and the constant spherical environment."""
    require_reference_builder()
    w, h = res
    if name == "mesh_heavy":
        d = testing.mesh_heavy(res=res, spp=n_samples, depth=3, n=2, subdiv=2)
    else:
        d = testing.cornell_sphere(resolution=res, spp=n_samples, depth=3)
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    assert tcomp.plan.num_tris == jcomp.plan.num_tris == n_tris
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pxy = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    kw = dict(max_depth=3, rr_depth=0, rr_threshold=0.95)
    for si in range(n_samples):
        rgb_ref, _, st_ref = jax_ptb(
            jcomp, jcomp.arrays, jscene.cameras[0], jscene.integrator.sampler,
            jscene.integrator.light_sampler, jnp.asarray(pxy), jnp.int32(si),
            with_stats=True, **kw)
        rgb, _, st = path_trace_batch(
            tcomp, tscene.cameras[0], tscene.integrator.sampler,
            tscene.integrator.light_sampler, torch.as_tensor(pxy), si, with_stats=True, **kw)
        assert st["fused"] == 0 and st["bounces"] >= 1
        assert abs(int(st["rays"]) - int(st_ref["rays"])) <= 4
        assert _frac_off(rgb.numpy(), np.asarray(rgb_ref)) < 0.02
        assert float(rgb.mean()) > 0.0


def test_env_cornell_matches_reference():
    """testing.cornell_box with the constant spherical environment of the
    reference's TestFusedEnvironment (tests/test_fused_path.py:269-277),
    16^2, depth 3, two samples: the reference's general fork (its CPU run)
    against the port's fused fork (its environment mode: candidates, escape
    state, miss pass) and the port's general fork (the miss term and the
    light sampler's environment pick), by this file's rule."""
    res, depth = 16, 3
    d = jtesting.cornell_box(resolution=(res, res), spp=2, depth=depth)
    d["render"]["environment"] = {"impl": "spherical", "prop": {
        "emission": {"impl": "constant", "prop": {"v": [0.4, 0.5, 0.7]}}}}
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    assert tcomp.plan.fused_path and tcomp.plan.has_environment
    pxy = _pixels(res)
    kw = dict(max_depth=depth, rr_depth=0, rr_threshold=0.95)
    for si in range(2):
        rgb_ref, _, st_ref = jax_ptb(
            jcomp, jcomp.arrays, jscene.cameras[0], jscene.integrator.sampler,
            jscene.integrator.light_sampler, jnp.asarray(pxy), jnp.int32(si),
            with_stats=True, **kw)
        args = (tcomp, tscene.cameras[0], tscene.integrator.sampler,
                tscene.integrator.light_sampler, torch.as_tensor(pxy), si)
        rgb_f, _, st_f = path_trace_batch(*args, with_stats=True, **kw)
        rgb_g, _, st_g = general_path_trace_batch(*args, **kw)
        assert st_f["fused"] == 1 and st_g["bounces"] >= 1
        for rgb, st in ((rgb_f, st_f), (rgb_g, st_g)):
            assert abs(int(st["rays"]) - int(st_ref["rays"])) <= 4
            assert _frac_off(rgb.numpy(), np.asarray(rgb_ref)) < 0.02
        assert float(rgb_f.mean()) > 0.0


def test_cluster_render_matches_golden():
    """testing.cornell_sphere (48^2, 8 spp, depth 5; 1,312 triangles, the
    cluster trace) against tests/golden/cornell_sphere_48_8spp.exr, the
    reference's CPU render, made with the JAX package on the CPU by:

        scene = lr.Scene.from_dict(testing.cornell_sphere(resolution=(48, 48),
                                                          spp=8, depth=5))
        img = lr.render(scene)["cornell.exr"]
        imageio.save_exr("tests/golden/cornell_sphere_48_8spp.exr", img)

    (`lr` = luisarender_tpu with its native SAH builder loaded, `testing` =
    luisarender_tpu_torch.testing, `imageio` = luisarender_tpu.utils.imageio).
    Under this file's rule, and the mean within 0.5%."""
    scene = lt.Scene.from_dict(testing.cornell_sphere(resolution=(48, 48), spp=8, depth=5))
    img = lt.render(scene, device="cpu")["cornell.exr"]
    assert scene.integrator.fused_passes == 0 and scene.integrator.bounces_run >= 8
    ref = imageio.load_exr(str(Path(__file__).parent / "golden" / "cornell_sphere_48_8spp.exr"))
    assert img.shape == ref.shape and np.all(np.isfinite(img))
    assert _frac_off(img, ref) < 0.02
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005


def test_save_writes_exr(tmp_path):
    d = testing.cornell_box(resolution=(8, 8), spp=1, depth=2)
    out = tmp_path / "c.exr"
    d["render"]["cameras"][0]["prop"]["file"] = str(out)
    img = lt.render(lt.Scene.from_dict(d), save=True, device="cpu")[str(out)]
    np.testing.assert_array_equal(imageio.load_exr(str(out)), img)
