"""The port's cluster trace (luisarender_tpu_torch/ops/cluster.py: its
tables, and the plain PyTorch walk that CPU tensors take) and the compiler's
SAH order against the reference (luisarender_tpu/ops/cluster_pallas.py,
accel/traverse.py, scene/compiler.py), on the CPU.

- Tables: `build_cluster_tables` equals the reference's exactly (the same
  SAH trees, the same float32 numpy arithmetic).
- Traces: the reference's own bar for its cluster kernel
  (tests/test_cluster_trace.py): over the same tables, closest hits against
  the reference's brute force (`trace_closest_brute` on the SAH-ordered
  rows) with misses and slots identical, t within rtol 1e-4 / atol 1e-5,
  u and v within 1e-5 (XLA may contract multiply-adds into FMAs, which the
  port does not); any-hit against `trace_any_brute` identical.
- Compiled scenes: the port's triangle order, trace, shade and cluster
  tables equal the reference's exactly, and `convert.py` carries them
  across unchanged.
- The ray sort of the CUDA route: the port's coherence keys equal the
  reference's `_coherence_keys` bit for bit, and a walk of the sorted rays
  scattered back equals the walk in caller order. Ties: inside one cluster
  of coincident triangles the plain walk takes the reference kernel's slot
  (both take the first row of least t).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu.accel.traverse import trace_any_brute, trace_closest_brute
from luisarender_tpu.core.types import Ray
from luisarender_tpu.ops import cluster_pallas
from luisarender_tpu_torch import convert, testing
from luisarender_tpu_torch.ops import cluster
from luisarender_tpu_torch.scene.compiler import SceneCompiler, tables_to_device

from torch_parity import (
    brute_geom, cluster_case, require_reference_builder, soup, soup_rays, to_torch,
)

N_RAYS = 1500
SIZES = [100, 700, 3000]  # one cluster; a small tree; a deeper one


@pytest.fixture(scope="module")
def reference():
    return require_reference_builder()


@pytest.mark.parametrize("n_tris", SIZES)
def test_cluster_tables_match_reference(reference, n_tris):
    positions, triangles, opaque, order, canon, nodes, tris = cluster_case(n_tris, 1)
    np.testing.assert_array_equal(order, reference.build_bvh_sah(positions, triangles).prim_index)
    ref_nodes, ref_tris = cluster_pallas.build_cluster_tables(positions, triangles, opaque, canon)
    np.testing.assert_array_equal(nodes, ref_nodes)
    np.testing.assert_array_equal(tris, ref_tris)
    # every triangle appears once, under its slot
    valid = tris[:, 9, :].ravel() > 0
    assert np.array_equal(np.sort(tris[:, 11, :].ravel()[valid]), np.arange(n_tris))


@pytest.mark.parametrize("n_tris", SIZES)
def test_plain_closest_matches_reference_brute(reference, n_tris):
    positions, triangles, opaque, order, _, nodes, tris = cluster_case(n_tris, 1)
    o, d, t_min, t_max = soup_rays(7, 3e38, N_RAYS)
    ref = trace_closest_brute(brute_geom(positions, triangles, opaque, order),
                              Ray(*(jnp.asarray(x) for x in (o, d, t_min, t_max))))
    c0 = cluster.closest_launches
    t, slot, u, v = (x.numpy() for x in cluster.closest(*to_torch(o, d, t_min, t_max, nodes, tris)))
    assert cluster.closest_launches == c0  # CPU tensors: the plain version
    t_ref, bary = np.asarray(ref.t), np.asarray(ref.bary)
    np.testing.assert_array_equal(np.isinf(t), np.isinf(t_ref))
    np.testing.assert_array_equal(slot, np.asarray(ref.prim))
    h = np.isfinite(t_ref)
    assert 0.02 < h.mean() < 0.9
    np.testing.assert_allclose(t[h], t_ref[h], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(u[h], bary[h, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(v[h], bary[h, 1], rtol=0, atol=1e-5)
    assert np.all(u[~h] == 0) and np.all(v[~h] == 0)


@pytest.mark.parametrize("n_tris", SIZES)
def test_plain_any_matches_reference_brute(reference, n_tris):
    positions, triangles, opaque, order, _, nodes, tris = cluster_case(n_tris, 2)
    o, d, t_min, t_max = soup_rays(9, 1.0, N_RAYS)
    ref = np.asarray(trace_any_brute(brute_geom(positions, triangles, opaque, order),
                                     Ray(*(jnp.asarray(x) for x in (o, d, t_min, t_max)))))
    a0 = cluster.any_launches
    occ = cluster.any_hit(*to_torch(o, d, t_min, t_max, nodes, tris)).numpy()
    assert cluster.any_launches == a0
    np.testing.assert_array_equal(occ, ref)
    assert 0.01 < occ.mean() < 0.9
    # the walk's counts: dead lanes pop nothing, live ones the root at least
    stats = cluster.walk_plain(*to_torch(o, d, t_min, t_max, nodes, tris), True)[5].numpy()
    live = t_max > t_min
    assert np.all(stats[~live] == 0) and np.all(stats[live, 0] >= 1)
    assert np.all(stats[:, 2] <= stats[:, 1] * cluster.CLUSTER)


def _malformed(kind):
    """A node table that loops (one pop after another, the stack never
    growing), one whose stack grows past STACK_DEPTH, and one with a child
    index past its end; one block of one triangle."""
    box = [-10.0, -10.0, -10.0, 10.0, 10.0, 10.0]
    if kind == "steps":  # node 0: left = leaf 1 (near for d.x >= 0), right = itself
        nodes = [box + [0.0, -1.0], box + [-1.0, 0.0]]
    elif kind == "stack":  # node k: left = k + 1 (near), right = itself
        nodes = [box + [float(k), -1.0] for k in range(128)]
    else:
        nodes = [box + [5.0, -1.0], box + [-1.0, 0.0]]
    tris = np.zeros((1, cluster.TRI_COLS, cluster.CLUSTER), np.float32)
    return np.asarray(nodes, np.float32), tris


@pytest.mark.parametrize("kind,message", [("steps", "pops"), ("stack", "stack deeper"),
                                          ("index", "out of range")])
def test_plain_walk_raises_on_malformed_tree(kind, message):
    nodes, tris = _malformed(kind)
    o, d = np.zeros((4, 3), np.float32), np.tile(np.float32([[1.0, 0.0, 0.0]]), (4, 1))
    args = to_torch(o, d, np.zeros(4, np.float32), np.full(4, np.inf, np.float32), nodes, tris)
    for fn in (cluster.closest, cluster.any_hit):
        with pytest.raises(RuntimeError, match=message):
            fn(*args)


@pytest.fixture(scope="module")
def compiled(reference):
    out = {}
    for name, d in (("cornell", testing.cornell_box(resolution=(8, 8), spp=1)),
                    ("cornell_sphere", testing.cornell_sphere(resolution=(8, 8)))):
        ref = lr.compile_scene(lr.Scene.from_dict(d))
        names = ([c.impl_names[0] for c in ref.plan.surface_types],
                 [c.impl_names[0] for c in ref.plan.light_types])
        arrays = jax.device_get(ref.arrays)
        port, plan = SceneCompiler(lt.Scene.from_dict(d)).compile_numpy()
        out[name] = (ref, arrays, names, port, plan)
    return out


# the triangle rows, the shade table and the binary SAH tree (ops/trace.py)
TRACE_KEYS = ("prim_index", "tri_v0", "tri_e1", "tri_e2", "tri_opaque", "shade_table",
              "aabb_min", "aabb_max", "skip", "node_first", "node_count")


@pytest.mark.parametrize("name,n_tris", [("cornell", 32), ("cornell_sphere", 1312)])
def test_compiled_scene_matches_reference(compiled, name, n_tris):
    ref, arrays, names, port, plan = compiled[name]
    keys = TRACE_KEYS + (("cluster_nodes", "cluster_tris") if n_tris > 512 else ())
    assert sorted(port["trace"]) == sorted(keys)
    for k in keys:
        np.testing.assert_array_equal(port["trace"][k], np.asarray(arrays["trace"][k]), k)
    assert plan.num_tris == ref.plan.num_tris == n_tris
    assert plan.fused_path == ref.plan.fused_path == (n_tris <= 64)
    # the reference's tables carried across are the port's own
    conv, conv_plan = convert.convert_tables(arrays, *names, ref.plan.bvh_leaf_size)
    assert conv_plan == plan
    for k in keys:
        np.testing.assert_array_equal(conv["trace"][k], port["trace"][k], k)
    dev = tables_to_device(conv, "cpu")["trace"]
    assert ("tri_table" in dev) == (n_tris <= 512)
    assert ("cluster_nodes" in dev) == (n_tris > 512)


def _key_rays(n=3000, seed=21):
    """Rays for the sort keys: a seventh dead, some along -x and +y exactly,
    origins inside and outside the box below."""
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * 2.0).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:100] = [-1.0, 0.0, 0.0]
    d[100:200] = [0.0, 1.0, 0.0]
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.where(rs.rand(n) < 0.5, np.inf, rs.rand(n) * 4.0).astype(np.float32)
    t_max[::7] = 0.0
    return o, d, t_min, t_max


@pytest.mark.parametrize("hi_y", [2.0, -0.5], ids=["box", "flat_box"])
def test_coherence_keys_match_reference(hi_y):
    o, d, t_min, t_max = _key_rays()
    lo = np.float32([-1.0, -0.5, -1.5])
    ext = np.float32([1.0, hi_y, 3.0]) - lo  # flat_box: no extent along y
    ref = np.asarray(cluster_pallas._coherence_keys(
        *(jnp.asarray(x) for x in (o, d, t_min, t_max, lo, ext))))
    got = cluster.coherence_keys(*to_torch(o, d, t_min, t_max, lo, ext)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.all(got[t_max <= t_min] == 0x40000000)
    assert np.unique(got).size > 500  # the keys tell the rays apart
    # the order: keys ascending, dead rays last, caller order within a key
    nodes = np.zeros((1, cluster.NODE_COLS), np.float32)
    nodes[0, 0:3], nodes[0, 3:6] = lo, lo + ext
    perm = cluster.coherence_order(*to_torch(o, d, t_min, t_max, nodes)).numpy()
    np.testing.assert_array_equal(perm, np.argsort(ref, kind="stable"))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_sorted_walk_matches_caller_order(reference, any_hit):
    *_, nodes, tris = cluster_case(700, 3)
    o, d, t_min, t_max = soup_rays(23, 1.0 if any_hit else 3e38)
    args = to_torch(o, d, t_min, t_max, nodes, tris)
    want = cluster.walk_plain(*args, any_hit)
    perm = cluster.coherence_order(*args[:5])
    assert not torch.equal(perm, torch.arange(perm.numel()))
    rays = [x[perm] for x in args[:4]]
    got = cluster.walk_plain(*rays, *args[4:], any_hit)
    for g, w in zip(got, want):
        back = torch.empty_like(g)
        back[perm] = g  # scattered back to caller order
        assert torch.equal(back, w)


def test_coincident_ties_match_reference_kernel(reference):
    """One cluster of 40 triangles, each three times (the same vertices),
    and rays aimed at them: the plain walk's slots equal the reference
    kernel's (interpret mode), which takes the first row of least t."""
    from luisarender_tpu_torch.accel.native import build_bvh_sah

    positions, base = soup(40, 31)
    triangles = np.repeat(base, 3, axis=0)
    n_tris = triangles.shape[0]
    order = build_bvh_sah(positions, triangles).prim_index
    canon = np.empty(n_tris, np.int64)
    canon[order] = np.arange(n_tris)
    opaque = np.ones(n_tris, bool)
    nodes, tris = cluster.build_cluster_tables(positions, triangles, opaque, canon)
    assert tris.shape[0] == 1
    rs = np.random.RandomState(32)
    n = 256
    o = rs.uniform(-0.5, 1.5, (n, 3)).astype(np.float32)
    aim = positions[base[rs.randint(0, 40, n)]].mean(axis=1)
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 3e38, np.float32)
    t, slot, _, _, _, _ = cluster.walk_plain(*to_torch(o, d, t_min, t_max, nodes, tris), False)
    ref = cluster_pallas.trace_closest_cluster(
        jnp.asarray(nodes), jnp.asarray(tris), Ray(*(jnp.asarray(x) for x in (o, d, t_min, t_max))),
        interpret=True)
    slot = slot.numpy()
    assert (slot >= 0).mean() > 0.8
    np.testing.assert_array_equal(slot, np.asarray(ref.prim))
    h = slot >= 0
    np.testing.assert_array_equal(np.isinf(t.numpy()), ~h)
    # each hit's slot is the first of its copies in the block's row order
    rows = tris[0, 11, :].astype(np.int64)
    first_row = {}
    for j, sl in enumerate(rows[tris[0, 9, :] > 0]):
        first_row.setdefault(tuple(tris[0, :9, j]), j)
    for sl in np.unique(slot[h]):
        j = int(np.nonzero(rows == sl)[0][0])
        assert first_row[tuple(tris[0, :9, j])] == j
