"""Two-level instancing in the port (accel/twolevel.py, accel/bvh.py's
Morton builder, the compiler's `_build_two_level`, the group and instance
shapes, scene/geometry.py's surface_interaction_2l) against the reference,
on the CPU, on the reference's tests/test_twolevel.py scene: four scaled
instances of one box OBJ under a light quad (torch_parity.instanced_scene;
here two surfaces), and its variant built of `instance` shapes in a
`group`, one of them `visible: false`.

(a) the Morton builder's arrays equal the reference's;
(b) the two-level tables equal the reference's (integers exactly, float32
    bit for bit; the world-to-object columns of the instance rows, from
    np.linalg.inv, within 1e-6 relative), as do the plan's statics and the
    tables convert.py carries across;
(c) the plain walk (trace_closest_2l / trace_any_2l) and the composition
    (the cluster trace an instance: its plain walk here) against the
    reference's XLA walk, its own CPU route: the same hits, prims and
    instances on every lane, t within 1e-5 relative (the bar of the
    reference's tests/test_twolevel.py:151-180), the same occlusion;
(d) the render, per sample, against the reference's two-level render by
    the reference's rule for its fused kernel (ray counts within 4, under
    2% of pixels off by more than 1e-3), against the port's own flat
    render by tests/test_twolevel.py:125's (mean |a - b| < 5e-3), and the
    reference's converted tables rendering the port's own image;
(e) the `auto` choice: flat on the small scene, two-level at the
    reference's threshold (no 8M-triangle scene is compiled here);
(f) a two-level Cornell box takes the general fork, one cluster trace an
    instance, as the reference's takes its general fork;
(g) an analytic sphere under two-level compiles as a mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu.accel import bvh as jbvh
from luisarender_tpu.accel import twolevel as jtl
from luisarender_tpu.integrators.mega_path import path_trace_batch as jax_ptb
from luisarender_tpu_torch import convert, testing
from luisarender_tpu_torch.accel import bvh, twolevel
from luisarender_tpu_torch.core.types import Ray
from luisarender_tpu_torch.integrators.mega_path import (
    general_path_trace_batch, path_trace_batch,
)
from luisarender_tpu_torch.ops import cluster
from luisarender_tpu_torch.scene.compiler import AUTO_TWO_LEVEL_TRIS, choose_two_level

from torch_parity import (
    count_calls, instanced_rays, instanced_scene, reference_ray, require_reference_builder,
    to_torch,
)


def _frac_off(a, b):
    return float((np.abs(a - b).max(-1) > 1e-3).mean())


def _pixels(res):
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)


def _compile_both(d):
    require_reference_builder()
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    tscene = lt.Scene.from_dict(d)
    return jcomp, tscene, lt.compile_scene(tscene, device="cpu")


def _assert_tables_equal(jcomp, tcomp):
    ref = jax.device_get(jcomp.arrays["trace2"])
    own = {k: v.numpy() for k, v in tcomp.arrays["trace2"].items()}
    assert sorted(own) == sorted(ref)
    for k, v in own.items():
        r = np.asarray(ref[k])
        assert v.dtype == r.dtype and v.shape == r.shape, k
        if k == "inst_rows":
            # world-to-object, np.linalg.inv in float64 then float32
            np.testing.assert_allclose(v[:, :12], r[:, :12], rtol=1e-6, atol=0)
            np.testing.assert_array_equal(v[:, 12:], r[:, 12:])
        else:
            np.testing.assert_array_equal(v, r, err_msg=k)
    for f in ("two_level", "tl_inst_mesh", "tl_inst_opaque", "tl_inst_visible", "tl_mesh_count",
              "num_tris", "bvh_leaf_size"):
        assert getattr(tcomp.plan, f) == getattr(jcomp.plan, f), f
    assert tcomp.arrays["trace"] == {} and not tcomp.plan.fused_path


# ---------------------------------------------------------------------------
# (a) the Morton builder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,leaf_size", [(1, 1), (5, 1), (27, 1), (64, 1), (100, 4)])
def test_morton_builder_matches_reference(n, leaf_size):
    rng = np.random.default_rng(n)
    lo = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 3, (n, 3)).astype(np.float32)
    own = bvh.build_bvh_boxes(lo, hi, leaf_size=leaf_size)
    ref = jbvh.build_bvh_boxes(lo, hi, leaf_size=leaf_size)
    for k in own._fields:
        a, b = getattr(own, k), getattr(ref, k)
        if k != "leaf_size":
            assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (own.prim_index >= 0).sum() == n  # the rest is padding, -1


def test_morton_triangle_builder_matches_reference():
    from torch_parity import soup

    positions, triangles = soup(37, seed=4)
    own, ref = bvh.build_bvh(positions, triangles), jbvh.build_bvh(positions, triangles)
    for k in own._fields:
        np.testing.assert_array_equal(getattr(own, k), getattr(ref, k), err_msg=k)
    with pytest.raises(ValueError):
        bvh.build_bvh(positions, triangles[:0])


# ---------------------------------------------------------------------------
# (b) the tables, and convert.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grouped", [False, True], ids=["meshes", "group_instances"])
def test_two_level_tables_match_reference(tmp_path, grouped):
    jcomp, tscene, tcomp = _compile_both(instanced_scene(tmp_path, "twolevel", grouped))
    _assert_tables_equal(jcomp, tcomp)
    # one box mesh shared by the four boxes, and the light quad
    if grouped:  # and the null quad, which blocks no shadow ray
        assert tcomp.plan.tl_inst_mesh == (0, 0, 0, 0, 1, 2)
        assert tcomp.plan.tl_inst_visible == (True, True, False, True, True, True)
        assert tcomp.plan.tl_inst_opaque == (True, True, True, True, False, True)
    else:
        assert tcomp.plan.tl_inst_mesh == (0, 0, 0, 0, 1)
        assert tcomp.plan.tl_inst_visible == tcomp.plan.tl_inst_opaque == (True,) * 5
    assert tcomp.arrays["trace2"]["tri_v0"].shape[0] == 12 + 2 + 2 * grouped
    surf = tcomp.arrays["instances"]["surface_index"].tolist()
    assert surf[1] != surf[0] and surf[3] != surf[0]  # red and white boxes
    # the reference's tables carried across: the port's own, with its plan
    conv = convert.convert(
        jax.device_get(jcomp.arrays), [c.impl_names[0] for c in jcomp.plan.surface_types],
        [c.impl_names[0] for c in jcomp.plan.light_types], tscene, device="cpu",
        bvh_leaf_size=jcomp.plan.bvh_leaf_size)
    for k, v in tcomp.arrays["trace2"].items():
        assert torch.equal(conv.arrays["trace2"][k], v), k
    for f in ("two_level", "tl_inst_mesh", "tl_inst_opaque", "tl_inst_visible", "tl_mesh_count",
              "num_tris"):
        assert getattr(conv.plan, f) == getattr(tcomp.plan, f), f


def test_instance_without_shape_raises(tmp_path):
    d = instanced_scene(tmp_path, "twolevel", grouped=True)
    del d["render"]["shapes"][0]["prop"]["shapes"][0]["prop"]["shape"]
    with pytest.raises(ValueError, match="requires 'shape'"):
        lt.Scene.from_dict(d)


def test_shared_meshes_resolve_to_one_object(tmp_path):
    """Two-level counts unique meshes by object: the same file, the same
    named node and the same sphere subdivision each give one MeshData."""
    scene = lt.Scene.from_dict(instanced_scene(tmp_path, "twolevel", grouped=True))
    group = scene.shapes[0]
    assert len({id(inst.children()[0].mesh()) for inst in group.children()}) == 1
    boxes = lt.Scene.from_dict(instanced_scene(tmp_path, "twolevel")).shapes[:4]
    assert len({id(s.mesh()) for s in boxes}) == 1
    d = testing.mesh_heavy(res=(8, 8), spp=1, n=2, subdiv=1)
    spheres = lt.Scene.from_dict(d).shapes[2:]
    assert len(spheres) == 4 and len({id(s.mesh()) for s in spheres}) == 1


# ---------------------------------------------------------------------------
# (c) the traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grouped", [False, True], ids=["meshes", "group_instances"])
def test_two_level_traces_match_reference(tmp_path, grouped):
    jcomp, _, tcomp = _compile_both(instanced_scene(tmp_path, "twolevel", grouped))
    rays_np = instanced_rays()
    jgeom = jcomp.trace_geometry()
    ref = jtl.trace_closest_2l(jgeom, reference_ray(*rays_np))
    occ_ref = np.asarray(jtl.trace_any_2l(jgeom, reference_ray(*rays_np)))
    r_prim, r_inst, r_t = (np.asarray(x) for x in (ref.prim, ref.inst, ref.t))
    hit = r_prim >= 0
    assert 0.05 < hit.mean() < 0.9 and 0.05 < occ_ref.mean() <= hit.mean()
    # the axis-aligned lanes reach the boxes and the light
    assert hit[-256:].mean() > 0.3 and set(r_inst[-256:][hit[-256:]]) >= {0, 1, 3, 4}
    if grouped:
        assert not (r_inst == 2).any() and (r_inst == 4).any()  # the null quad
        assert (hit & ~occ_ref).any()

    geom = tcomp.trace_geometry()
    rays = Ray(*to_torch(*rays_np))
    calls = {}
    for name, closest, any_hit in (
        ("plain", twolevel.trace_closest_2l, twolevel.trace_any_2l),
        ("composition", twolevel.trace_closest_2l_cluster, twolevel.trace_any_2l_cluster),
    ):
        h = closest(geom, rays)
        prim, inst, t = h.prim.numpy(), h.inst.numpy(), h.t.numpy()
        np.testing.assert_array_equal(prim >= 0, hit, err_msg=name)
        np.testing.assert_array_equal(prim, r_prim, err_msg=name)
        np.testing.assert_array_equal(inst, r_inst, err_msg=name)
        np.testing.assert_allclose(t[hit], r_t[hit], rtol=1e-5, atol=0, err_msg=name)
        assert np.isinf(t[~hit]).all()
        np.testing.assert_array_equal(any_hit(geom, rays).numpy(), occ_ref, err_msg=name)
        calls[name] = h
    # the composition's (u, v) are the plain walk's, row for row
    np.testing.assert_allclose(calls["composition"].bary.numpy()[hit],
                               calls["plain"].bary.numpy()[hit], rtol=0, atol=1e-6)


def test_routing_takes_the_composition(tmp_path, monkeypatch):
    """accel/traverse.py sends a two-level geometry to the composition: a
    cluster trace a visible instance (any-hit: a visible opaque one), and
    raises where the cluster tables are missing."""
    from luisarender_tpu_torch.accel import traverse

    tcomp = lt.compile_scene(lt.Scene.from_dict(instanced_scene(tmp_path, "twolevel", True)),
                             device="cpu")
    geom = tcomp.trace_geometry()
    rays = Ray(*to_torch(*instanced_rays(n=256)))
    calls = count_calls(monkeypatch, cluster)
    traverse.trace_closest(geom, rays)
    traverse.trace_any(geom, rays)
    # six instances: box 2 is invisible, the null quad blocks no shadow ray
    assert calls[("cluster", "closest")] == 5 and calls[("cluster", "any_hit")] == 4
    with pytest.raises(ValueError, match="cluster tables"):
        traverse.trace_closest(geom._replace(cluster_sets=()), rays)
    with pytest.raises(ValueError, match="cluster tables"):
        traverse.trace_any(geom._replace(cluster_sets=()), rays)
    # a mesh tree whose walk never ends raises, as the flat trace does
    box = [-1e3, -1e3, -1e3, 1e3, 1e3, 1e3]
    loop = torch.tensor([box + [0.0, -1.0], box + [-1.0, 0.0]])
    bad = geom._replace(cluster_sets=tuple((loop, t) for _, t in geom.cluster_sets))
    for trace in (traverse.trace_closest, traverse.trace_any):
        with pytest.raises(RuntimeError, match="malformed cluster tree"):
            trace(bad, rays)


# ---------------------------------------------------------------------------
# (d) the render
# ---------------------------------------------------------------------------


def test_two_level_render_matches_reference(tmp_path):
    res, spp, depth = 48, 16, 3
    d = instanced_scene(tmp_path, "twolevel", res=res, spp=spp, depth=depth)
    jcomp, tscene, tcomp = _compile_both(d)
    jscene = lr.Scene.from_dict(d)
    assert jcomp.plan.two_level and not jcomp.plan.fused_path
    fscene = lt.Scene.from_dict(instanced_scene(tmp_path, "flat", res=res, spp=spp, depth=depth))
    fcomp = lt.compile_scene(fscene, device="cpu")
    assert not fcomp.plan.two_level
    pxy = _pixels(res)
    kw = dict(max_depth=depth, rr_depth=0, rr_threshold=0.95)
    # one compile of the reference's sample (unjitted, its while loops
    # compile anew at every call)
    ref_sample = jax.jit(lambda arrays, si: jax_ptb(
        jcomp, arrays, jscene.cameras[0], jscene.integrator.sampler,
        jscene.integrator.light_sampler, jnp.asarray(pxy), si, with_stats=True, **kw))
    acc_2l = acc_flat = 0.0
    for si in range(spp):
        rgb_ref, _, st_ref = ref_sample(jcomp.arrays, jnp.int32(si))
        rgb, _, st = path_trace_batch(
            tcomp, tscene.cameras[0], tscene.integrator.sampler,
            tscene.integrator.light_sampler, torch.as_tensor(pxy), si, with_stats=True, **kw)
        assert st["fused"] == 0 and st["bounces"] >= 1
        assert abs(int(st["rays"]) - int(st_ref["rays"])) <= 4
        assert _frac_off(rgb.numpy(), np.asarray(rgb_ref)) < 0.02
        rgb_f, _, _ = general_path_trace_batch(
            fcomp, fscene.cameras[0], fscene.integrator.sampler,
            fscene.integrator.light_sampler, torch.as_tensor(pxy), si, **kw)
        acc_2l = acc_2l + rgb.numpy()
        acc_flat = acc_flat + rgb_f.numpy()
    img_2l, img_flat = acc_2l / spp, acc_flat / spp
    assert np.isfinite(img_2l).all() and img_2l.mean() > 0.0
    assert np.abs(img_2l - img_flat).mean() < 5e-3

    # the reference's tables, carried across, render the port's own image
    conv = convert.convert(
        jax.device_get(jcomp.arrays), [c.impl_names[0] for c in jcomp.plan.surface_types],
        [c.impl_names[0] for c in jcomp.plan.light_types], tscene, device="cpu",
        bvh_leaf_size=jcomp.plan.bvh_leaf_size)
    rgb_conv, rgb_own = (
        path_trace_batch(comp, tscene.cameras[0], tscene.integrator.sampler,
                         tscene.integrator.light_sampler, torch.as_tensor(pxy), 0, **kw)[0]
        for comp in (conv, tcomp))
    assert torch.equal(rgb_conv, rgb_own)


def test_red_and_white_instances_shade_apart(tmp_path):
    """The interaction takes the instance from the hit: a camera ray into
    the red box (instance 1) comes back red, one into a white box grey."""
    from luisarender_tpu_torch.accel import traverse
    from luisarender_tpu_torch.scene.geometry import surface_interaction

    d = instanced_scene(tmp_path, "twolevel", res=8, spp=1, depth=2)
    tcomp = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")

    o = torch.tensor([[0.0, 0.0, 12.0], [-3.0, 0.0, 12.0]])
    dirs = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    rays = Ray(o, dirs, torch.zeros(2), torch.full((2,), float("inf")))
    hit = traverse.trace_closest(tcomp.trace_geometry(), rays)
    it = surface_interaction(tcomp.arrays, hit, rays)
    assert it.inst.tolist() == [1, 0] and it.valid.all()
    np.testing.assert_allclose(it.p.numpy(), [[0, 0, 1], [-3, 0, 1]], atol=1e-5)
    np.testing.assert_allclose(it.ng.numpy(), [[0, 0, 1], [0, 0, 1]], atol=1e-6)
    np.testing.assert_allclose(it.prim_area.numpy(), [1.2 * 2.0, 2.0], rtol=1e-5)
    kd = tcomp.arrays["surfaces"][0]["kd"][tcomp.arrays["instances"]["surface_index"][it.inst]]
    np.testing.assert_allclose(kd.numpy(), [[0.7, 0.2, 0.2], [0.7, 0.7, 0.7]], rtol=1e-6)


# ---------------------------------------------------------------------------
# (e)-(g) the choice of path
# ---------------------------------------------------------------------------


def test_auto_choice_matches_reference(tmp_path):
    jcomp, _, tcomp = _compile_both(instanced_scene(tmp_path, "auto"))
    assert not tcomp.plan.two_level and not jcomp.plan.two_level
    assert "shade_table" in tcomp.arrays["trace"] and "trace2" not in tcomp.arrays
    # testing.mesh_heavy(n=20, subdiv=5): 400 icospheres of 20,480 triangles
    # plus the two quads
    assert choose_two_level("auto", 8_192_004, 20_484)
    assert not choose_two_level("auto", 8_000_000, 20_484)  # not past 8M
    assert not choose_two_level("auto", 9_000_000, 2_250_001)  # not past 4x unique
    assert choose_two_level("twolevel", 50, 14) and not choose_two_level("flat", 10**9, 14)
    assert AUTO_TWO_LEVEL_TRIS == 8_000_000


def test_two_level_cornell_takes_the_general_fork(monkeypatch):
    d = testing.cornell_box(resolution=(16, 16), spp=1, depth=2)
    d["render"]["accel"] = "twolevel"
    jcomp, tscene, tcomp = _compile_both(d)
    assert jcomp.plan.two_level and not jcomp.plan.fused_path
    assert tcomp.plan.two_level and not tcomp.plan.fused_path and "fused" not in tcomp.arrays
    n_inst = len(tcomp.plan.tl_inst_mesh)
    calls = count_calls(monkeypatch, cluster)
    rgb, _, st = path_trace_batch(
        tcomp, tscene.cameras[0], tscene.integrator.sampler, tscene.integrator.light_sampler,
        torch.as_tensor(_pixels(16)), 0, with_stats=True, max_depth=2, rr_depth=0,
        rr_threshold=0.95)
    assert st["fused"] == 0 and st["bounces"] == 2
    assert calls[("cluster", "closest")] == 2 * n_inst
    assert calls[("cluster", "any_hit")] == 2 * sum(tcomp.plan.tl_inst_opaque)
    assert torch.isfinite(rgb).all() and float(rgb.mean()) > 0.0


def test_analytic_sphere_compiles_as_mesh_under_two_level():
    d = testing.cornell_box(resolution=(16, 16), spp=1, depth=2)
    d["render"]["accel"] = "twolevel"
    d["render"]["shapes"].append({"impl": "sphere", "prop": {
        "subdivision": 2, "surface": {"impl": "matte", "prop": {}},
        "transform": {"impl": "srt", "prop": {"scale": [80, 80, 80],
                                              "translate": [186, 250, 168]}}}})
    jcomp, _, tcomp = _compile_both(d)
    assert tcomp.plan.num_spheres == 0 == jcomp.plan.num_spheres
    assert "sph" not in tcomp.arrays["trace"]
    _assert_tables_equal(jcomp, tcomp)
    # flattened, the same sphere is an exact quadric
    d["render"]["accel"] = "flat"
    assert lt.compile_scene(lt.Scene.from_dict(d), device="cpu").plan.num_spheres == 1
