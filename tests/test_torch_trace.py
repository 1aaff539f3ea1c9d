"""The port's binary-tree trace (luisarender_tpu_torch/ops/trace.py: its
tables, and the plain PyTorch walk that CPU tensors take) against the
reference (luisarender_tpu/ops/trace_pallas.py), on the CPU.

- Tables: `pack_tables` over the port's SAH tree equals the reference's
  over the same tree (np.array_equal).
- Traces, at tests/test_pallas_trace.py's sizes (random soups in the unit
  cube): against the reference's kernel in interpret mode over the same
  tables (100 triangles, 1,024 rays) and against its brute force over the
  same SAH-ordered rows (400 triangles, 2,048 rays): misses and prims
  identical, t within rtol 1e-4 / atol 1e-5 (the bar of
  test_pallas_trace.py; XLA may contract multiply-adds into FMAs, the port
  does not), u and v within 1e-5.
- The stack bound of the walk (`tree_stack`) is the tree's depth + 1, and
  the stack build a launch takes for a bound (`stack_build`) is the least
  of 32, 64 and 512 entries that holds it.
- Malformed trees (a loop, a walk past the stack bound it is given, a bound
  past the kernel's largest stack, a child index out of range) raise.
- The walk's order: the reference's (left child first, the first hit of
  least t). On hand-built trees whose two leaves hold the same triangle (an
  exact t tie across leaves) the walk returns the reference kernel's and
  its XLA walk's prim, the lower row, on every ray: where either leaf's box
  is entered first, and where the tie lies in the plane of the lower-row
  leaf's entry face, which a nearer-box-first walk would cull on some rays
  (its slab entry rounds above the tie's t). The SAH builder lays the
  leaves' rows out in preorder (soups of 100, 400 and 5,000 triangles and
  scenes/cornell.json as the compiler builds it), so "met first" is "least
  row". On a 5,000-triangle soup the walk returns what the walk in the
  reference's order over the node table (`preorder_plain`) does, bit for
  bit, with the same leaves and rows, and 2 V - 1 node pops for V pair
  rows visited on a live ray.
- The child-pair table (`build_pairs`) holds, for the root and each
  interior node, the boxes and codes the node table gives its children.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisarender_tpu.accel.traverse import (TraceGeometry, trace_closest_brute,
                                            trace_closest_bvh)
from luisarender_tpu.ops import trace_pallas
from luisarender_tpu_torch.accel import traverse
from luisarender_tpu_torch.accel.native import build_bvh_sah
from luisarender_tpu_torch.ops import trace

from torch_parity import (
    face_tie_tree, malformed_tree, reference_ray, require_reference_builder, soup, soup_rays,
    tie_tree, to_torch,
)


@pytest.fixture(scope="module")
def reference():
    return require_reference_builder()


def rays(n_rays, seed):
    """soup_rays with an infinite t_max and t_min = 0, as camera rays."""
    o, d, _, t_max = soup_rays(seed, np.inf, n_rays)
    return o, d, np.zeros(n_rays, np.float32), t_max


def trees(verts, tris):
    """The port's TraceGeometry over its SAH tree and the reference's over
    the same tree and rows."""
    bvh = build_bvh_sah(verts, tris)
    srt = tris[bvh.prim_index]
    v0, v1, v2 = (verts[srt[:, k]] for k in range(3))
    arrays = {"tri_v0": v0, "tri_e1": v1 - v0, "tri_e2": v2 - v0,
              "prim_index": bvh.prim_index, "aabb_min": bvh.aabb_min,
              "aabb_max": bvh.aabb_max, "skip": bvh.skip, "node_first": bvh.node_first,
              "node_count": bvh.node_count}
    geom = TraceGeometry(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        tri_opaque=jnp.ones(tris.shape[0], bool), leaf_size=bvh.leaf_size,
        num_tris=tris.shape[0])
    port = traverse.TraceGeometry(num_rows=tris.shape[0], leaf_size=bvh.leaf_size,
                                  **{k: torch.as_tensor(v) for k, v in arrays.items()})
    return port, geom, bvh.leaf_size


def check_hits(out, ref):
    t, prim, u, v = (x.numpy() for x in out)
    t_ref, bary = np.asarray(ref.t), np.asarray(ref.bary)
    np.testing.assert_array_equal(np.isinf(t), np.isinf(t_ref))
    np.testing.assert_array_equal(prim, np.asarray(ref.prim))
    h = np.isfinite(t_ref)
    assert 0.02 < h.mean() < 0.9
    np.testing.assert_allclose(t[h], t_ref[h], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(u[h], bary[h, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(v[h], bary[h, 1], rtol=0, atol=1e-5)


def test_pack_tables_match_reference(reference):
    port, geom, _ = trees(*soup(400, 21))
    ref_nodes, ref_tris = trace_pallas.pack_tables(geom)
    nodes, tris = trace.pack_tables(port)
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(ref_nodes))
    np.testing.assert_array_equal(tris.numpy(), np.asarray(ref_tris))
    # a walk pushes both children and pops one: the tree's depth + 1
    depth = np.zeros(nodes.shape[0], np.int64)
    for i in range(nodes.shape[0]):  # preorder: a parent comes before its children
        if nodes[i, 7] <= 0:
            for c in (i + 1, int(nodes[i + 1, 6])):
                depth[c] = depth[i] + 1
    assert trace.tree_stack(nodes) == depth.max() + 1


def test_plain_matches_reference_kernel(reference):
    port, geom, leaf_size = trees(*soup(100, 23))
    o, d, t_min, t_max = rays(1024, 24)
    ref = trace_pallas.trace_closest_pallas(geom, reference_ray(o, d, t_min, t_max),
                                            interpret=True)
    l0 = trace.launches
    out = trace.closest(*to_torch(o, d, t_min, t_max), *trace.pack_tables(port), leaf_size)
    assert trace.launches == l0  # CPU tensors: the plain version
    check_hits(out, ref)


def test_plain_matches_reference_brute(reference):
    verts, tris = soup(400, 21)
    port, geom, leaf_size = trees(verts, tris)
    o, d, t_min, t_max = rays(2048, 22)
    ref = trace_closest_brute(geom._replace(prim_index=jnp.arange(400, dtype=jnp.int32)),
                              reference_ray(o, d, t_min, t_max))
    args = to_torch(o, d, t_min, t_max)
    out = trace.closest(*args, *trace.pack_tables(port), leaf_size)
    check_hits(out, ref)
    stats = trace.walk_plain(*args, *trace.pack_tables(port), leaf_size)[4].numpy()
    live = t_max > t_min
    assert np.all(stats[~live] == 0) and np.all(stats[live, 0] >= 1)
    assert np.all(stats[:, 2] <= stats[:, 1] * leaf_size)


@pytest.mark.parametrize("kind,message", [("steps", "pops"), ("stack", "stack deeper"),
                                          ("deep", "stack deeper"), ("index", "out of range")])
def test_plain_walk_raises_on_malformed_tree(kind, message):
    nodes, tris, stack = malformed_tree(kind)
    o, d = np.zeros((4, 3), np.float32), np.tile(np.float32([[1.0, 0.0, 0.0]]), (4, 1))
    args = to_torch(o, d, np.zeros(4, np.float32), np.full(4, np.inf, np.float32), nodes, tris)
    with pytest.raises(RuntimeError, match=message):
        trace.closest(*args, 4, stack=stack)


def test_wrapper_rejects_bad_inputs():
    nodes, tris, _ = malformed_tree("steps")
    o, d, t_min, t_max = to_torch(np.zeros((4, 3), np.float32), np.ones((4, 3), np.float32),
                                  np.zeros(4, np.float32), np.ones(4, np.float32))
    nodes, tris = torch.as_tensor(nodes), torch.as_tensor(tris)
    with pytest.raises(TypeError):
        trace.closest(o.double(), d, t_min, t_max, nodes, tris, 4)
    with pytest.raises(ValueError, match="shape"):
        trace.closest(o, d, t_min, t_max, nodes[:, :8], tris, 4)
    with pytest.raises(ValueError, match="leaf size"):
        trace.closest(o, d, t_min, t_max, nodes, tris, 0)


@pytest.mark.parametrize("bound,build", [(1, 32), (23, 32), (32, 32), (33, 64), (64, 64),
                                         (65, 512), (512, 512), (513, 0), (0, 0)])
def test_stack_build_for_bound(bound, build):
    assert trace.stack_build(bound) == build


def rows_ascend_in_preorder(node_first, node_count):
    """The leaves' first rows, taken in preorder, ascend, and each leaf's
    rows follow the last one's."""
    leaf = np.asarray(node_count) > 0
    first, count = np.asarray(node_first)[leaf], np.asarray(node_count)[leaf]
    return first[0] == 0 and np.array_equal(first[1:], first[:-1] + count[:-1])


@pytest.mark.parametrize("n_tris", [100, 400, 5000])
def test_leaf_rows_ascend_in_preorder_on_soups(n_tris):
    bvh = build_bvh_sah(*soup(n_tris, n_tris))
    assert rows_ascend_in_preorder(bvh.node_first, bvh.node_count)


def test_leaf_rows_ascend_in_preorder_on_a_scene():
    import luisarender_tpu_torch as lt

    compiled = lt.compile_scene(lt.load_scene("scenes/cornell.json"), device="cpu")
    tr = compiled.arrays["trace"]
    assert (np.asarray(tr["node_count"]) > 0).sum() > 1
    assert rows_ascend_in_preorder(tr["node_first"], tr["node_count"])


@pytest.mark.parametrize("dup_met_first", [False, True], ids=["dup_left_nearer",
                                                              "dup_right_nearer"])
def test_exact_tie_across_leaves_takes_the_lower_row(reference, dup_met_first):
    arrays, (o, d, t_min, t_max) = tie_tree(dup_met_first)
    geom = TraceGeometry(**{k: jnp.asarray(v) for k, v in arrays.items()},
                         tri_opaque=jnp.ones(4, bool), leaf_size=4, num_tris=4)
    ray = reference_ray(o, d, t_min, t_max)
    port = traverse.TraceGeometry(num_rows=4, leaf_size=4,
                                  **{k: torch.as_tensor(v) for k, v in arrays.items()})
    args = to_torch(o, d, t_min, t_max)
    nodes, tris = trace.pack_tables(port)
    out = trace.walk_plain(*args, nodes, tris, 4)
    prim, stats = out[1].numpy(), out[4].numpy()
    assert prim[0] == prim[1] == -1 and np.all(prim[2:] == 1)
    assert np.all(stats[2:, 1] == 2)  # both leaves entered: the tie is met
    for ref in (trace_pallas.trace_closest_pallas(geom, ray, interpret=True),
                trace_closest_bvh(geom, ray)):
        np.testing.assert_array_equal(prim, np.asarray(ref.prim))
        np.testing.assert_allclose(out[0].numpy()[2:], np.asarray(ref.t)[2:], rtol=1e-6)
    # the same answer from the walk in the reference's order
    for a, b in zip(out[:4], trace.preorder_plain(*args, nodes, tris, 4)[:4]):
        assert torch.equal(a, b)


def test_face_plane_tie_takes_the_reference_row(reference):
    from luisarender_tpu_torch.ops.cluster import safe_inv, slab_range

    arrays, (o, d, t_min, t_max) = face_tie_tree()
    geom = TraceGeometry(**{k: jnp.asarray(v) for k, v in arrays.items()},
                         tri_opaque=jnp.ones(4, bool), leaf_size=4, num_tris=4)
    ray = reference_ray(o, d, t_min, t_max)
    port = traverse.TraceGeometry(num_rows=4, leaf_size=4,
                                  **{k: torch.as_tensor(v) for k, v in arrays.items()})
    args = to_torch(o, d, t_min, t_max)
    nodes, tris = trace.pack_tables(port)
    out = trace.walk_plain(*args, nodes, tris, 4)
    prim = out[1].numpy()
    assert np.all(prim == 0)
    for ref in (trace_pallas.trace_closest_pallas(geom, ray, interpret=True),
                trace_closest_bvh(geom, ray)):
        np.testing.assert_array_equal(prim, np.asarray(ref.prim))
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref.t), rtol=1e-6)
    for a, b in zip(out[:4], trace.preorder_plain(*args, nodes, tris, 4)[:4]):
        assert torch.equal(a, b)
    # the case is met: the right box is entered first, and on some rays the
    # left box's entry lies past the tie's t, where a nearer-box-first walk
    # would cull it
    o_, d_ = args[0], args[1]
    inv = [safe_inv(d_[:, k]) for k in range(3)]
    ray_t = (o_[:, 0], o_[:, 1], o_[:, 2], *inv, args[2], args[3])
    near_left = slab_range(nodes[1:2, 0:6].expand(64, 6), *ray_t)[0]
    near_right = slab_range(nodes[2:3, 0:6].expand(64, 6), *ray_t)[0]
    assert bool((near_right < near_left).all())
    assert 0 < int((near_left > out[0]).sum()) < 64


def test_walk_matches_the_reference_order():
    port, _, leaf_size = trees(*soup(5000, 25))
    nodes, tris = trace.pack_tables(port)
    args = to_torch(*soup_rays(26, np.inf, 4000))
    walk = trace.walk_plain(*args, nodes, tris, leaf_size)
    pre = trace.preorder_plain(*args, nodes, tris, leaf_size)
    for a, b in zip(walk[:4], pre[:4]):
        assert torch.equal(a, b)
    assert 0.1 < float((walk[1] >= 0).float().mean()) < 0.9
    # the same leaves and rows; a pair row visited for each interior node
    # entered (and row 0), where that walk pops both children of each
    assert torch.equal(walk[4][:, 1:], pre[4][:, 1:])
    live = (args[2] < torch.clamp(args[3], max=3e38)).to(torch.int32)
    assert torch.equal(pre[4][:, 0], 2 * walk[4][:, 0] - live)


def test_pair_table_holds_each_nodes_children():
    port, _, leaf_size = trees(*soup(400, 21))
    nodes, _ = trace.pack_tables(port)
    pairs = trace.build_pairs(nodes, leaf_size)
    nodes, words = nodes.numpy(), pairs.view(torch.int32).numpy()
    pairs = pairs.numpy()
    interior = np.nonzero(nodes[:, 7] <= 0)[0]
    assert pairs.shape == (1 + interior.size, trace.PAIR_COLS)
    row_of = {int(i): 1 + k for k, i in enumerate(interior)}

    def code(c):
        if nodes[c, 7] <= 0:
            return row_of[c]
        m = min(int(nodes[c, 7]), leaf_size)
        return ~((int(nodes[c, 8]) << trace.LEAF_BITS) | (m - 1))

    parents = [(0, [0])] + [(1 + k, [i + 1, int(nodes[i + 1, 6])])
                            for k, i in enumerate(interior)]
    for row, kids in parents:
        for slot, c in enumerate(kids):
            np.testing.assert_array_equal(pairs[row, 8 * slot:8 * slot + 6], nodes[c, 0:6])
            assert words[row, 6 + slot] == code(c)
    assert words[0, 7] == trace.NONE
