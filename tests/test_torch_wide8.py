"""The port's wide8 trace (luisarender_tpu_torch/ops/wide8.py: the plain
PyTorch walk that CPU tensors take) against the reference, on the CPU.

- Traces: the reference's own exact bar for its wide8 kernel
  (tests/test_subpacket_trace.py test_wide8_*): over the same tables,
  closest hits against the reference's brute force (`trace_closest_brute`
  on the SAH-ordered rows) with misses and slots identical, t within
  rtol 1e-5 / atol 1e-6, u and v within 1e-5; any-hit against
  `trace_any_brute` identical. The reference's wide8 kernel itself is not
  run: in interpret mode it costs ~50 s a case.
- A hand-built tree whose root pop hits several leaf clusters that overlap
  along the rays (torch_parity.overlapping_leaves_bvh8): the re-test of a
  later leaf's box against the best t an earlier leaf left drops it; hits
  against the reference's brute force, the walk's per-ray pops, leaves and
  rows against the values the case implies.
- A deep 8-wide tree whose stack bound is past the kernels' smaller stack
  (torch_parity.deep_bvh8: 21 levels, 141 entries) traces as brute force.
- The kernel build a launch takes for a stack bound (`stack_build`).
- Malformed 8-wide trees (a loop, a walk past the stack bound it is given,
  a bound past the kernels' largest stack, a child index out of range)
  raise, in both modes.
- Render: testing.cornell_sphere (48^2, 8 spp, depth 5) with the route
  switched on, against tests/golden/cornell_sphere_48_8spp.exr under the
  rule of tests/test_torch_render.py, with the wide8 trace on every bounce.
"""

from pathlib import Path

import numpy as np
import pytest

import luisarender_tpu_torch as lt
from luisarender_tpu.accel.traverse import trace_any_brute, trace_closest_brute
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.ops import cluster, subpacket, wide8
from luisarender_tpu_torch.utils import imageio

from torch_parity import (
    brute_geom, cluster_case, count_calls, deep_bvh8, malformed_bvh8, overlapping_leaves_bvh8,
    reference_ray, require_reference_builder, soup_rays, to_torch,
)

SPHERE_GOLDEN = Path(__file__).parent / "golden" / "cornell_sphere_48_8spp.exr"


@pytest.fixture(scope="module")
def reference():
    return require_reference_builder()


def wide_tables(nodes):
    slab8, meta8 = subpacket.build_slab_meta(subpacket.build_bvh8(nodes))
    return slab8, meta8, wide8.build_cluster_boxes(nodes)


@pytest.mark.parametrize("n_tris", [700, 8000])
def test_plain_closest_matches_reference_brute(reference, n_tris):
    positions, triangles, opaque, order, _, nodes, tris = cluster_case(n_tris, 1)
    o, d, t_min, t_max = soup_rays(7, 3e38)
    ref = trace_closest_brute(brute_geom(positions, triangles, opaque, order),
                              reference_ray(o, d, t_min, t_max))
    c0 = wide8.closest_launches
    t, slot, u, v = (x.numpy() for x in wide8.closest(
        *to_torch(o, d, t_min, t_max, *wide_tables(nodes), tris)))
    assert wide8.closest_launches == c0  # CPU tensors: the plain version
    t_ref, bary = np.asarray(ref.t), np.asarray(ref.bary)
    np.testing.assert_array_equal(np.isinf(t), np.isinf(t_ref))
    np.testing.assert_array_equal(slot, np.asarray(ref.prim))
    h = np.isfinite(t_ref)
    assert 0.02 < h.mean() < 0.9
    np.testing.assert_allclose(t[h], t_ref[h], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u[h], bary[h, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(v[h], bary[h, 1], rtol=0, atol=1e-5)
    assert np.all(u[~h] == 0) and np.all(v[~h] == 0)


@pytest.mark.parametrize("n_tris", [700, 8000])
def test_plain_any_matches_reference_brute(reference, n_tris):
    positions, triangles, opaque, order, _, nodes, tris = cluster_case(n_tris, 2)
    o, d, t_min, t_max = soup_rays(9, 1.0)
    ref = np.asarray(trace_any_brute(brute_geom(positions, triangles, opaque, order),
                                     reference_ray(o, d, t_min, t_max)))
    a0 = wide8.any_launches
    args = to_torch(o, d, t_min, t_max, *wide_tables(nodes), tris)
    occ = wide8.any_hit(*args).numpy()
    assert wide8.any_launches == a0
    np.testing.assert_array_equal(occ, ref)
    assert 0.01 < occ.mean() < 0.9
    # the walk's counts: dead lanes pop nothing, live ones the root at least
    stats = wide8.wide8_plain(*args, True).stats.numpy()
    live = t_max > t_min
    assert np.all(stats[~live] == 0) and np.all(stats[live, 0] >= 1)
    assert np.all(stats[:, 2] <= stats[:, 1] * cluster.CLUSTER)


def test_overlapping_leaves_culled_by_the_retest():
    tables, (positions, triangles), rays, want = overlapping_leaves_bvh8()
    geom = brute_geom(positions, triangles, np.ones(4, bool), np.arange(4))
    ref = trace_closest_brute(geom, reference_ray(*rays))
    args = to_torch(*rays, *tables)
    st = wide8.wide8_plain(*args, False)
    t, slot, u, v = (x.numpy() for x in wide8.closest(*args))
    np.testing.assert_array_equal(slot, np.asarray(ref.prim))
    np.testing.assert_array_equal(slot, want["slot"])
    np.testing.assert_array_equal(t, want["t"])
    np.testing.assert_allclose(t, np.asarray(ref.t), rtol=1e-5, atol=1e-6)
    h = slot >= 0
    np.testing.assert_allclose(u[h], np.asarray(ref.bary)[h, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(v[h], np.asarray(ref.bary)[h, 1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(st.stats.numpy(), want["stats"])
    occ = wide8.any_hit(*args).numpy()
    np.testing.assert_array_equal(occ, np.asarray(trace_any_brute(geom, reference_ray(*rays))))
    np.testing.assert_array_equal(occ, want["occ"])
    np.testing.assert_array_equal(wide8.wide8_plain(*args, True).stats.numpy(),
                                  want["stats_any"])


@pytest.mark.parametrize("bound,build", [(1, 48), (34, 48), (48, 48), (49, 2048), (141, 2048),
                                         (2048, 2048), (2049, 0), (0, 0)])
def test_stack_build_for_bound(bound, build):
    """The least of the kernel's stacks that holds the tree's bound; the
    mesh-heavy scene's bound (34) takes the small build."""
    assert wide8.stack_build(bound) == build


def test_deep_tree_matches_reference_brute(reference):
    slab8, meta8, cboxes, tris, _, positions, triangles = deep_bvh8()
    assert subpacket.bvh8_depth(meta8) == 21
    assert subpacket.stack8_need(meta8) == 141 > subpacket.STACKS8[0]
    c = tris.shape[0]
    geom = brute_geom(positions, triangles, np.ones(c, bool), np.arange(c))
    o, d, t_min, t_max = soup_rays(11, 3e38, 600)
    ref = trace_closest_brute(geom, reference_ray(o, d, t_min, t_max))
    t, slot, u, v = (x.numpy() for x in wide8.closest(
        *to_torch(o, d, t_min, t_max, slab8, meta8, cboxes, tris)))
    t_ref, bary = np.asarray(ref.t), np.asarray(ref.bary)
    np.testing.assert_array_equal(slot, np.asarray(ref.prim))
    h = np.isfinite(t_ref)
    assert 0.02 < h.mean() < 0.9
    np.testing.assert_allclose(t[h], t_ref[h], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u[h], bary[h, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(v[h], bary[h, 1], rtol=0, atol=1e-5)
    o, d, t_min, t_max = soup_rays(12, 1.0, 600)
    occ = wide8.any_hit(*to_torch(o, d, t_min, t_max, slab8, meta8, cboxes, tris)).numpy()
    np.testing.assert_array_equal(occ, np.asarray(trace_any_brute(
        geom, reference_ray(o, d, t_min, t_max))))
    assert 0.01 < occ.mean() < 0.9


@pytest.mark.parametrize("kind,message", [("steps", "pops"), ("stack", "stack deeper"),
                                          ("deep", "stack deeper"), ("index", "out of range")])
def test_plain_walk_raises_on_malformed_tree(kind, message):
    slab8, meta8, stack = malformed_bvh8(kind)
    tris = np.zeros((1, cluster.TRI_COLS, cluster.CLUSTER), np.float32)
    cboxes = np.zeros((1, 8), np.float32)
    o, d = np.zeros((4, 3), np.float32), np.tile(np.float32([[1.0, 0.0, 0.0]]), (4, 1))
    args = to_torch(o, d, np.zeros(4, np.float32), np.full(4, np.inf, np.float32),
                    slab8, meta8, cboxes, tris)
    for fn in (wide8.closest, wide8.any_hit):
        with pytest.raises(RuntimeError, match=message):
            fn(*args, stack=stack)


def test_render_matches_golden(monkeypatch):
    """The golden is the reference's render on its default (cluster) route;
    the wide8 trace's hits equal the cluster trace's but for exact ties."""
    monkeypatch.setattr(wide8, "ENABLED", True)
    scene = lt.Scene.from_dict(testing.cornell_sphere(resolution=(48, 48), spp=8, depth=5))
    calls = count_calls(monkeypatch, wide8, cluster)
    img = lt.render(scene, device="cpu")["cornell.exr"]
    bounces = scene.integrator.bounces_run
    assert bounces >= 8 and calls == {("wide8", "closest"): bounces, ("wide8", "any_hit"): bounces,
                                      ("cluster", "closest"): 0, ("cluster", "any_hit"): 0}
    ref = imageio.load_exr(str(SPHERE_GOLDEN))
    assert img.shape == ref.shape and np.all(np.isfinite(img))
    assert float((np.abs(img - ref).max(-1) > 1e-3).mean()) < 0.02
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005
