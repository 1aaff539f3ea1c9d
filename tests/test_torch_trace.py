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
- The stack bound of the walk (`tree_stack`) is the tree's depth + 1.
- Malformed trees (a loop, a walk past the stack bound it is given, a bound
  past the kernel's largest stack, a child index out of range) raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisarender_tpu.accel.traverse import TraceGeometry, trace_closest_brute
from luisarender_tpu.ops import trace_pallas
from luisarender_tpu_torch.accel import traverse
from luisarender_tpu_torch.accel.native import build_bvh_sah
from luisarender_tpu_torch.ops import trace

from torch_parity import (
    malformed_tree, reference_ray, require_reference_builder, soup, soup_rays, to_torch,
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
