"""The port's 8-wide tree tables and the binary SAH tree it now keeps
(luisarender_tpu_torch/ops/subpacket.py, ops/wide8.py, ops/trace.py
pack_tables, scene/compiler.py, convert.py) against the reference
(luisarender_tpu/ops/subpacket_pallas.py, wide8_pallas.py, trace_pallas.py,
scene/compiler.py), on the CPU.

- The BVH8 table, its slab / meta tables, the Woop blocks and the cluster
  boxes equal the reference's exactly (np.array_equal), built from the same
  cluster tables of the 700- and 8,000-triangle soups, and in a compiled
  `cornell_sphere` with both opt-in routes switched on in both packages.
- The compiled scene's binary tree (aabb_min, aabb_max, skip, node_first,
  node_count; leaf size on the plan) and `pack_tables` equal the
  reference's; `convert.py` carries every one of these tables across.
- The compiler builds the 8-wide tables only when a route asks for them,
  and routes as the reference: closest subpacket, then wide8, then cluster;
  any-hit wide8, then cluster.
"""

import jax
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu.ops import cluster_pallas, subpacket_pallas, trace_pallas, wide8_pallas
from luisarender_tpu_torch import convert, testing
from luisarender_tpu_torch.accel import traverse
from luisarender_tpu_torch.core.types import make_ray
from luisarender_tpu_torch.ops import cluster, subpacket, trace, wide8
from luisarender_tpu_torch.scene.compiler import SceneCompiler, tables_to_device

from torch_parity import cluster_case, count_calls, require_reference_builder

BVH8_KEYS = ("cluster_woop", "cluster_slab8", "cluster_meta8", "cluster_cboxes")
TREE_KEYS = ("aabb_min", "aabb_max", "skip", "node_first", "node_count")


@pytest.fixture(scope="module")
def reference():
    return require_reference_builder()


@pytest.mark.parametrize("n_tris", [700, 8000])
def test_soup_tables_match_reference(reference, n_tris):
    positions, triangles, opaque, _, canon, nodes, tris = cluster_case(n_tris, 1)
    ref_nodes, ref_tris = cluster_pallas.build_cluster_tables(positions, triangles, opaque,
                                                              canon)
    np.testing.assert_array_equal(nodes, ref_nodes)
    table8 = subpacket.build_bvh8(nodes)
    np.testing.assert_array_equal(table8, subpacket_pallas.build_bvh8(ref_nodes))
    slab8, meta8 = subpacket.build_slab_meta(table8)
    ref_slab8, ref_meta8 = subpacket_pallas.build_slab_meta(table8)
    np.testing.assert_array_equal(slab8, ref_slab8)
    np.testing.assert_array_equal(meta8, ref_meta8)
    np.testing.assert_array_equal(subpacket.build_woop_table(tris),
                                  subpacket_pallas.build_woop_table(ref_tris))
    np.testing.assert_array_equal(wide8.build_cluster_boxes(nodes),
                                  wide8_pallas.build_cluster_boxes(ref_nodes))
    # the 8,000-triangle tree has more than one level of 8-wide nodes
    assert (table8.shape[0] > 1) == (n_tris == 8000)
    assert subpacket.bvh8_depth(meta8) == (3 if n_tris == 8000 else 1)


@pytest.fixture(scope="module")
def compiled_sphere(reference):
    """cornell_sphere compiled by both packages with both opt-in routes on,
    then by the port with them off."""
    d = testing.cornell_sphere(resolution=(8, 8))
    mp = pytest.MonkeyPatch()
    try:
        for mod in (subpacket_pallas, wide8_pallas, subpacket, wide8):
            mp.setattr(mod, "ENABLED", True)
        ref = lr.compile_scene(lr.Scene.from_dict(d))
        arrays = jax.device_get(ref.arrays)
        port, plan = SceneCompiler(lt.Scene.from_dict(d)).compile_numpy()
    finally:
        mp.undo()
    off, _ = SceneCompiler(lt.Scene.from_dict(d)).compile_numpy()
    return ref, arrays, port, plan, off


def test_compiled_tables_match_reference(compiled_sphere):
    ref, arrays, port, plan, off = compiled_sphere
    for k in BVH8_KEYS + TREE_KEYS:
        assert k in port["trace"], k
        np.testing.assert_array_equal(port["trace"][k], np.asarray(arrays["trace"][k]), k)
    assert plan.bvh_leaf_size == ref.plan.bvh_leaf_size == 4
    # the 8-wide walk's stack bound, for the kernels' choice of stack
    assert plan.bvh8_stack == subpacket.stack8_need(port["trace"]["cluster_meta8"]) >= 1
    assert not any(k in off["trace"] for k in BVH8_KEYS)
    assert all(k in off["trace"] for k in TREE_KEYS)
    # the reference's pack_tables over its own trace geometry
    ref_nodes, ref_tris = trace_pallas.pack_tables(ref.trace_geometry())
    nodes, tris = trace.pack_tables(traverse.TraceGeometry(
        num_rows=plan.num_tris,
        **{k: port["trace"][k] for k in ("tri_v0", "tri_e1", "tri_e2", "prim_index")
           + TREE_KEYS}))
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(ref_nodes))
    np.testing.assert_array_equal(tris.numpy(), np.asarray(ref_tris))


def test_convert_carries_the_tables(compiled_sphere):
    ref, arrays, port, plan, _ = compiled_sphere
    names = ([c.impl_names[0] for c in ref.plan.surface_types],
             [c.impl_names[0] for c in ref.plan.light_types])
    conv, conv_plan = convert.convert_tables(arrays, *names, ref.plan.bvh_leaf_size)
    assert conv_plan == plan
    assert sorted(conv["trace"]) == sorted(port["trace"])
    for k in port["trace"]:
        np.testing.assert_array_equal(conv["trace"][k], port["trace"][k], k)


def _counts():
    return (cluster.closest_launches, cluster.any_launches, wide8.closest_launches,
            wide8.any_launches, subpacket.closest_launches, subpacket.any_launches)


@pytest.mark.parametrize("wide, sub, closest_to, any_to", [
    (False, False, "cluster", "cluster"),
    (True, False, "wide8", "wide8"),
    (False, True, "subpacket", "cluster"),
    (True, True, "subpacket", "wide8"),
])
def test_routes(monkeypatch, compiled_sphere, wide, sub, closest_to, any_to):
    """Which module's wrapper each trace calls (on CPU tensors each runs its
    plain version and counts no launch); a subpacket hit has bary = NaN."""
    _, _, port, plan, _ = compiled_sphere
    geom = tables_to_device(port, "cpu")["trace"]
    monkeypatch.setattr(wide8, "ENABLED", wide)
    monkeypatch.setattr(subpacket, "ENABLED", sub)
    tg = traverse.TraceGeometry(
        num_rows=geom["shade_table"].shape[0], cluster_nodes=geom["cluster_nodes"],
        cluster_tris=geom["cluster_tris"], **{k: geom[k] for k in BVH8_KEYS})
    calls = count_calls(monkeypatch, cluster, wide8, subpacket)
    rng = np.random.default_rng(3)
    o = torch.as_tensor(rng.uniform(100, 450, (64, 3)).astype(np.float32))
    d = torch.as_tensor(rng.normal(size=(64, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    before = _counts()
    hit = traverse.trace_closest(tg, make_ray(o, d, 1e-3))
    traverse.trace_any(tg, make_ray(o, d, 1e-3, 200.0))
    assert {k for k, v in calls.items() if v} == {(closest_to, "closest"), (any_to, "any_hit")}
    assert sum(calls.values()) == 2
    assert _counts() == before
    assert bool(torch.isnan(hit.bary).all()) == (closest_to == "subpacket")
