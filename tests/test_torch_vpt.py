"""The port's volumetric path tracer (luisarender_tpu_torch/integrators/
mega_vpt.py, `megavpt`) and the scene system's media against the JAX
package, on the CPU:

(a) scenes/fog.json (a homogeneous fog sphere of 5,120 null-surface
    triangles in the Cornell box: the cluster route) and testing.fog_grid
    (the same sphere holding a 32^3 density grid) at 32^2, 8 spp, depth 10
    against tests/golden/fog_32_8spp.exr and fog_grid_32_8spp.exr, the
    reference's CPU renders, by its rule: under 2% of pixels off by more
    than 1e-3, the mean within 0.5%;
(b) the reference's slab scenes (tests/test_media.py) at 16^2, 16 spp,
    each sample against the reference's jitted sample by that rule: the
    absorbing homogeneous slab, whose view holds Beer-Lambert, and the
    constant-density grid slab, whose image equals the homogeneous one's
    (the reference's own tests hold both against Beer-Lambert at 64 and
    128 spp);
(c) a camera inside an `environment_medium` (the Cornell box in thin fog),
    sample by sample against the reference;
(d) scenes/fog.json loaded by load_scene and rendered by render_file with
    device="cpu" at 8^2, 1 spp; the reference's compiled fog scene carried
    across (convert.py: the media rows, the instances' medium columns, the
    grids, the plan's medium types and env_medium_ref) renders the port's
    own sample bit for bit;
(e) the repairs: a sphere with a medium stays a mesh (the reference's
    analytic-sphere test), and a scene with media never takes the fused
    fork (has_media, or an instance's medium tag);
(f) all 69 of the reference's plugins registered, the integrators
    constructing as the reference's classes.
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
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.integrators.mega_vpt import vpt_trace_batch
from luisarender_tpu_torch.utils import imageio

import torch_parity
from test_media import _grid_slab_scene, _slab_scene

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"


@pytest.fixture(autouse=True, scope="module")
def _reference_builder():
    torch_parity.require_reference_builder()


def _frac_off(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) > 1e-3).mean())


def _pixels(w, h):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)


# ---------------------------------------------------------------------------
# (a) the goldens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fog", "fog_grid"])
def test_fog_matches_golden(name):
    d = (testing.fog((32, 32), 8, 10) if name == "fog"
         else testing.fog_grid((32, 32), 8, 10))
    scene = lt.Scene.from_dict(d)
    comp = lt.compile_scene(scene, device="cpu")
    assert "cluster_nodes" in comp.arrays["trace"] and comp.plan.num_tris == 5152
    assert comp.plan.has_media and not comp.plan.fused_path
    img = scene.integrator.render(comp)["fog.exr"]
    assert scene.integrator.iterations_run >= 8 * 10
    ref = imageio.load_exr(str(GOLDEN / f"{name}_32_8spp.exr"))
    assert img.shape == ref.shape == (32, 32, 3) and np.isfinite(img).all()
    assert _frac_off(img, ref) < 0.02
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005


# ---------------------------------------------------------------------------
# (b) the slabs, (c) the environment medium: sample by sample
# ---------------------------------------------------------------------------


def _against_reference(d, spp):
    """Each of spp samples of the port against the reference's jitted one;
    returns the port's mean image (H, W, 3)."""
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    w, h = tscene.cameras[0].film.resolution
    pxy = _pixels(w, h)
    ji, ti = jscene.integrator, tscene.integrator
    ref_sample = jax.jit(lambda arrays, si: ji._trace_batch(
        jcomp, arrays, jscene.cameras[0], jnp.asarray(pxy), si))
    acc = 0.0
    for si in range(spp):
        rgb_ref, _ = ref_sample(jcomp.arrays, jnp.int32(si))
        rgb, _, stats = vpt_trace_batch(
            tcomp, tscene.cameras[0], ti.sampler, ti.light_sampler, torch.as_tensor(pxy), si,
            max_depth=ti.max_depth, rr_depth=ti.rr_depth, rr_threshold=ti.rr_threshold)
        rgb = rgb.numpy()
        assert np.isfinite(rgb).all() and stats["iterations"] >= 1
        assert _frac_off(rgb, np.asarray(rgb_ref)) < 0.02, si
        acc = acc + rgb
    return (acc / spp).reshape(h, w, 3)


SIGMA = (0.8, 0.4, 0.1)
SLAB_SPP = 16
_SLABS = {}


def _slab(kind):
    """The absorbing slab of tests/test_media.py (thickness 2, sigma_a
    SIGMA, an emitter of 3 behind it), homogeneous or a grid of density 1,
    at 16^2 and SLAB_SPP spp, each sample held against the reference's;
    the port's image, computed once a module."""
    if kind not in _SLABS:
        d = (_slab_scene(SIGMA, spp=SLAB_SPP) if kind == "homogeneous"
             else _grid_slab_scene(SIGMA, [1.0] * 64, (4, 4, 4), spp=SLAB_SPP))
        _SLABS[kind] = _against_reference(d, SLAB_SPP)
    return _SLABS[kind]


def test_absorbing_slab_matches_reference():
    """Beer-Lambert: the view's mean within the reference's rtol 0.06 of
    3 exp(-2 sigma_a) (the view is within 17 degrees of the normal)."""
    img = _slab("homogeneous")
    np.testing.assert_allclose(img.mean(axis=(0, 1)), 3.0 * np.exp(-2.0 * np.asarray(SIGMA)),
                               rtol=0.06)


def test_constant_grid_slab_matches_reference():
    """Density 1 everywhere: delta tracking gives the homogeneous slab's
    image, the view's mean within 3% a channel (0.8% at 16 spp on the
    CPU)."""
    grid, homog = _slab("grid"), _slab("homogeneous")
    np.testing.assert_allclose(grid.mean(axis=(0, 1)), homog.mean(axis=(0, 1)), rtol=0.03)


def test_environment_medium_matches_reference():
    d = testing.cornell_box(resolution=(16, 16), spp=2, depth=6, integrator="megavpt")
    d["render"]["environment_medium"] = {"impl": "homogeneous", "prop": {
        "sigma_a": [0.0005, 0.001, 0.0015], "sigma_s": [0.002, 0.002, 0.002],
        "phase": {"impl": "hg", "prop": {"g": -0.2}}}}
    comp = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    assert comp.plan.env_medium_ref == (0, 0, 0.0) and comp.plan.has_media
    assert not comp.plan.fused_path
    img = _against_reference(d, 2)
    assert img.mean() > 0.0


# ---------------------------------------------------------------------------
# (d) the scene file and converted tables
# ---------------------------------------------------------------------------


def test_fog_scene_file_renders_on_cpu(tmp_path):
    d = json.loads((ROOT / "scenes" / "fog.json").read_text())
    scene = lt.load_scene(str(ROOT / "scenes" / "fog.json"))
    assert type(scene.integrator).__name__ == "MegakernelVolumePathTracing"
    medium = scene.shapes[-1].medium
    assert type(medium).__name__ == "HomogeneousMedium" and medium.phase.g == pytest.approx(0.3)
    cam = d["render"]["cameras"][0]["prop"]
    cam["film"]["prop"]["resolution"] = [8, 8]
    cam["spp"] = 1
    cam["file"] = str(tmp_path / "fog.exr")
    small = tmp_path / "fog.json"
    small.write_text(json.dumps(d))
    img = lt.render_file(str(small), save=True, device="cpu")[cam["file"]]
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0.0
    np.testing.assert_array_equal(imageio.load_exr(cam["file"]), img)


def test_converted_fog_scene_renders_like_the_port():
    from luisarender_tpu_torch import convert

    d = testing.fog_grid((16, 16), 1, 6, dims=(8, 6, 5), seed=3)
    d["render"]["environment_medium"] = {"impl": "homogeneous", "prop": {
        "sigma_a": [0.0005, 0.001, 0.0015], "sigma_s": [0.002, 0.002, 0.002]}}
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    conv = convert.convert(
        jax.device_get(jcomp.arrays), [c.impl_names[0] for c in jcomp.plan.surface_types],
        [c.impl_names[0] for c in jcomp.plan.light_types], tscene, device="cpu",
        bvh_leaf_size=jcomp.plan.bvh_leaf_size,
        medium_types=[c.impl_names[0] for c in jcomp.plan.medium_types],
        env_medium_ref=jcomp.plan.env_medium_ref)
    assert conv.plan.medium_types == tcomp.plan.medium_types
    assert conv.plan.env_medium_ref == tcomp.plan.env_medium_ref == (1, 0, 0.0)
    for key in convert.GRID_KEYS:
        assert torch.equal(conv.arrays[key], tcomp.arrays[key]), key
    for k, v in tcomp.arrays["instances"].items():
        assert torch.equal(conv.arrays["instances"][k], v), k
    integ = tscene.integrator
    kw = dict(max_depth=6, rr_depth=0, rr_threshold=0.95)
    rgb_conv, rgb_own = (
        vpt_trace_batch(comp, tscene.cameras[0], integ.sampler, integ.light_sampler,
                        torch.as_tensor(_pixels(16, 16)), 1, **kw)[0]
        for comp in (conv, tcomp))
    assert torch.equal(rgb_conv, rgb_own) and rgb_own.mean() > 0


# ---------------------------------------------------------------------------
# (e) the repairs
# ---------------------------------------------------------------------------


def _glass_sphere_box(medium):
    d = testing.cornell_box(resolution=(8, 8), spp=1, depth=3, integrator="megavpt")
    prop = {"surface": {"impl": "glass", "prop": {}},
            "transform": {"impl": "srt", "prop": {"scale": [80, 80, 80],
                                                  "translate": [278, 250, 280]}}}
    if medium is not None:
        prop["medium"] = {"impl": medium, "prop": {
            "sigma_a": [0.01, 0.02, 0.03], "sigma_s": [0.01, 0.01, 0.01]}
            if medium == "homogeneous" else {}}
    d["render"]["shapes"].append({"impl": "sphere", "prop": prop})
    return d


@pytest.mark.parametrize("medium", [None, "vacuum", "homogeneous"])
def test_sphere_with_a_medium_stays_a_mesh(medium):
    """The reference refuses the exact quadric to a sphere that carries a
    medium (a vacuum or null one aside): enter / exit parity needs the
    mesh."""
    d = _glass_sphere_box(medium)
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    tcomp = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    analytic = medium != "homogeneous"
    assert tcomp.plan.num_spheres == jcomp.plan.num_spheres == int(analytic)
    assert tcomp.plan.num_tris == jcomp.plan.num_tris
    np.testing.assert_array_equal(tcomp.arrays["instances"]["medium_tag"].numpy(),
                                  np.asarray(jcomp.arrays["instances"]["medium_tag"]))
    assert int(tcomp.arrays["instances"]["medium_tag"][-1]) == (-1 if analytic else 0)


def test_media_keep_a_scene_off_the_fused_fork():
    """An opaque Cornell box on megapath with an environment medium takes
    the general fork in both packages, and the fused pack refuses an
    instance with a medium tag even when has_media is not set."""
    from luisarender_tpu_torch.ops import fused_path

    d = testing.cornell_box(resolution=(8, 8), spp=1, depth=3)
    plain = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    assert plain.plan.fused_path
    d["render"]["environment_medium"] = {"impl": "homogeneous", "prop": {
        "sigma_a": [0.001, 0.001, 0.001]}}
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    assert not jcomp.plan.fused_path and not tcomp.plan.fused_path
    assert not fused_path.use_fused(tcomp, tscene.integrator.sampler,
                                    tscene.integrator.light_sampler)

    from luisarender_tpu_torch.scene.compiler import SceneCompiler

    sc = SceneCompiler(lt.Scene.from_dict(testing.cornell_box(resolution=(8, 8), spp=1)))
    arrays, _ = sc.compile_numpy()
    inst = {k: list(v) for k, v in arrays["instances"].items()}
    entries = {k: list(v) for k, v in arrays["light_entries"].items()}
    args = (sc._surface_types, sc._surface_rows, sc._light_types, sc._light_rows)
    kw = dict(spectrum=sc.spectrum, num_tris=32, all_opaque=True)
    assert fused_path.build_fused_pack(*args, inst, entries, **kw) is not None
    inst["medium_tag"][3] = 0
    assert fused_path.build_fused_pack(*args, inst, entries, **kw) is None


# ---------------------------------------------------------------------------
# (f) the plugins
# ---------------------------------------------------------------------------


def test_registered_plugins():
    from luisarender_tpu.scene.registry import _REGISTRY as JREG
    from luisarender_tpu_torch.scene.registry import _REGISTRY as TREG

    def count(reg):
        return sum(len(set(v.values())) for v in reg.values())

    assert count(JREG) == 69 and count(TREG) == 69
    d = testing.cornell_box(resolution=(8, 8), spp=1)
    for impl in ("megavpt", "normal", "direct", "aov", "photon", "sppm", "megapm", "pssmlt",
                 "mlt", "gpt", "gradient"):
        d["render"]["integrator"]["impl"] = impl
        assert type(lt.Scene.from_dict(d).integrator).__name__ == type(
            lr.Scene.from_dict(d).integrator).__name__
