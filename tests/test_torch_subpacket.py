"""The port's subpacket trace (luisarender_tpu_torch/ops/subpacket.py: the
plain PyTorch walk that CPU tensors take) and the (u, v) recompute of
scene/geometry.py against the reference, on the CPU.

- Traces, under the reference's own rule for its subpacket kernel
  (tests/test_subpacket_trace.py): the Woop test is an algebraic
  rearrangement of Moller-Trumbore, so under 0.5% of lanes may flip
  between hit and miss, t on common hits is within rtol 2e-4 / atol 1e-4,
  over 99.5% of their slots agree, and any-hit agrees on at least 99.8% of
  lanes. Closest hits are held against the reference's kernel in interpret
  mode at 700 triangles, over the same tables, and against its brute force
  at 8,000; any-hit against its brute force. Hits carry bary = NaN. Against
  the reference's kernel the rule is bit equality of t and slot on every
  lane: the port's Woop test is its matmul and sums as XLA compiles them,
  fused multiply-adds in row order (ops/subpacket.py woop_tests).
- surface_interaction recomputes (u, v) of NaN-bary hits from the shade row
  while the route is on: positions within 1e-4 of the brute-force bary
  path's, no NaN anywhere (the counterpart of
  test_nan_bary_interaction_recompute).
- `fma32`, the plain version's fused multiply-add, rounds a * b + c once:
  it equals the exactly computed sum rounded to nearest, ties to even.
- A deep 8-wide tree whose stack bound is past the kernels' smaller stack
  (torch_parity.deep_bvh8) traces as brute force, under the same rule.
- Malformed 8-wide trees raise, in both modes.
- A hand-built Woop case (torch_parity.woop_ties_bvh8: two rows of one
  cluster tying in t with the lower row on the higher slot, a pop hitting
  several leaf clusters along the ray, a transparent hit in front of an
  opaque one) bit for bit against the reference's kernel in interpret mode,
  both modes, and its walk counts against the values the case implies.
- The stack build a launch takes for a tree's bound (`stack_build`), and
  the bounds no build holds raising (`resolve_stack8`).
- The Woop tables' direction rows (rows 4-6 of groups 3-5) equal their
  origin rows (rows 0-2 of groups 0-2) bit for bit, on the tables both the
  port's and the reference's builders make: the plain version and the
  kernels take d' from the origin rows.
- `coherence_order` against the reference's `_coherence_keys` sorted
  stably, over the scene's bounds in meta8.
- Render: testing.cornell_sphere (48^2, 8 spp, depth 5) on the subpacket
  route (closest hits by subpacket, shadow rays by the cluster trace)
  against tests/golden/cornell_sphere_48_8spp.exr under the rule of
  tests/test_torch_render.py.
"""

from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu_torch as lt
from luisarender_tpu.accel.traverse import trace_any_brute, trace_closest_brute
from luisarender_tpu.ops import subpacket_pallas
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.accel import traverse
from luisarender_tpu_torch.core.types import Hit, Ray
from luisarender_tpu_torch.ops import cluster, subpacket
from luisarender_tpu_torch.scene.geometry import build_shade_table, surface_interaction
from luisarender_tpu_torch.utils import imageio

from torch_parity import (
    brute_geom, cluster_case, count_calls, deep_bvh8, malformed_bvh8, reference_ray,
    require_reference_builder, soup_rays, to_torch, woop_ties_bvh8,
)

SPHERE_GOLDEN = Path(__file__).parent / "golden" / "cornell_sphere_48_8spp.exr"


@pytest.fixture(scope="module")
def reference():
    return require_reference_builder()


def sub_tables(nodes, tris):
    slab8, meta8 = subpacket.build_slab_meta(subpacket.build_bvh8(nodes))
    return slab8, meta8, subpacket.build_woop_table(tris)


def assert_rule(t, slot, t_ref, slot_ref):
    """The reference's rule for the subpacket trace against another trace."""
    flip = np.isinf(t) != np.isinf(t_ref)
    assert flip.mean() < 0.005, f"{flip.sum()} hit/miss flips"
    h = np.isfinite(t) & np.isfinite(t_ref)
    np.testing.assert_allclose(t[h], t_ref[h], rtol=2e-4, atol=1e-4)
    agree = slot[h] == slot_ref[h]
    assert agree.mean() > 0.995, f"{(~agree).sum()} winner flips"
    np.testing.assert_array_equal(slot < 0, np.isinf(t))


@pytest.mark.parametrize("n_tris", [700, 8000])
def test_plain_closest_matches_reference(reference, n_tris):
    """700 triangles: the reference's kernel in interpret mode over the same
    tables; 8,000: its brute force."""
    positions, triangles, opaque, order, _, nodes, tris = cluster_case(n_tris, 1)
    o, d, t_min, t_max = soup_rays(7, 3e38)
    tables = sub_tables(nodes, tris)
    if n_tris == 700:
        ref = subpacket_pallas.trace_closest_subpacket(
            *(jnp.asarray(x) for x in tables), reference_ray(o, d, t_min, t_max),
            interpret=True)
    else:
        ref = trace_closest_brute(brute_geom(positions, triangles, opaque, order),
                                  reference_ray(o, d, t_min, t_max))
    c0 = subpacket.closest_launches
    t, slot, u, v = (x.numpy() for x in subpacket.closest(*to_torch(o, d, t_min, t_max,
                                                                     *tables)))
    assert subpacket.closest_launches == c0  # CPU tensors: the plain version
    assert 0.02 < np.isfinite(t).mean() < 0.9
    assert_rule(t, slot, np.asarray(ref.t), np.asarray(ref.prim))
    if n_tris == 700:  # the reference's own kernel: the same arithmetic
        np.testing.assert_array_equal(t, np.asarray(ref.t))
        np.testing.assert_array_equal(slot, np.asarray(ref.prim))
    assert np.all(np.isnan(u)) and np.all(np.isnan(v))  # the NaN-bary contract


def test_plain_any_matches_reference_brute(reference):
    positions, triangles, opaque, order, _, nodes, tris = cluster_case(700, 2)
    o, d, t_min, t_max = soup_rays(9, 1.0)
    ref = np.asarray(trace_any_brute(brute_geom(positions, triangles, opaque, order),
                                     reference_ray(o, d, t_min, t_max)))
    a0 = subpacket.any_launches
    args = to_torch(o, d, t_min, t_max, *sub_tables(nodes, tris))
    occ = subpacket.any_hit(*args).numpy()
    assert subpacket.any_launches == a0
    assert (occ == ref).mean() >= 0.998
    assert 0.01 < occ.mean() < 0.9
    stats = subpacket.subpacket_plain(*args, True).stats.numpy()
    live = t_max > t_min
    assert np.all(stats[~live] == 0) and np.all(stats[live, 0] >= 1)


def test_fma32_rounds_once():
    rng = np.random.default_rng(5)
    n = 3000
    a, b = (rng.standard_normal(n) * np.exp2(rng.integers(-40, 40, n)) for _ in range(2))
    a, b = a.astype(np.float32), b.astype(np.float32)
    # near cancellation on two thirds of the lanes, any c on the rest
    c = (-(a.astype(np.float64) * b) * (1.0 + rng.standard_normal(n) * 1e-6)).astype(np.float32)
    c[::3] = (rng.standard_normal(len(c[::3])) * np.exp2(rng.integers(-90, 90, len(c[::3])))
              ).astype(np.float32)
    got = subpacket.fma32(*to_torch(a, b, c)).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        near = np.float32(float(exact))
        cands = (np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf)))
        want = min(cands, key=lambda x: (abs(Fraction(float(x)) - exact), int(x.view(np.int32)) & 1))
        assert got[i] == want, (a[i], b[i], c[i], got[i], want)


def test_deep_tree_matches_reference_brute(reference):
    slab8, meta8, _, tris, woop, positions, triangles = deep_bvh8()
    assert subpacket.stack8_need(meta8) > subpacket.STACKS8[0]
    c = tris.shape[0]
    geom = brute_geom(positions, triangles, np.ones(c, bool), np.arange(c))
    o, d, t_min, t_max = soup_rays(11, 3e38, 300)
    ref = trace_closest_brute(geom, reference_ray(o, d, t_min, t_max))
    t, slot, _, _ = (x.numpy() for x in subpacket.closest(
        *to_torch(o, d, t_min, t_max, slab8, meta8, woop)))
    assert 0.02 < np.isfinite(t).mean() < 0.9
    assert_rule(t, slot, np.asarray(ref.t), np.asarray(ref.prim))
    o, d, t_min, t_max = soup_rays(12, 1.0, 300)
    occ = subpacket.any_hit(*to_torch(o, d, t_min, t_max, slab8, meta8, woop)).numpy()
    ref_occ = np.asarray(trace_any_brute(geom, reference_ray(o, d, t_min, t_max)))
    assert (occ == ref_occ).mean() >= 0.998 and 0.01 < occ.mean() < 0.9


def test_woop_ties_match_reference():
    """The reference's kernel in interpret mode on the hand-built case: t,
    slot and occlusion bit for bit; the walk counts the case implies."""
    tables, _, rays, want = woop_ties_bvh8()
    ref_tables = [jnp.asarray(x) for x in tables]
    ref = subpacket_pallas.trace_closest_subpacket(*ref_tables, reference_ray(*rays),
                                                   interpret=True)
    ref_occ = subpacket_pallas.trace_any_subpacket(*ref_tables, reference_ray(*rays),
                                                   interpret=True)
    args = to_torch(*rays, *tables)
    t, slot, _, _ = (x.numpy() for x in subpacket.closest(*args))
    np.testing.assert_array_equal(t, np.asarray(ref.t))
    np.testing.assert_array_equal(slot, np.asarray(ref.prim))
    np.testing.assert_array_equal(slot, want["slot"])
    np.testing.assert_allclose(t, want["t"], rtol=1e-6)
    occ = subpacket.any_hit(*args).numpy()
    np.testing.assert_array_equal(occ, np.asarray(ref_occ))
    np.testing.assert_array_equal(occ, want["occ"])
    for any_hit, key in ((False, "stats"), (True, "stats_any")):
        np.testing.assert_array_equal(subpacket.subpacket_plain(*args, any_hit).stats.numpy(),
                                      want[key])


@pytest.mark.parametrize("bound,build", [(1, 48), (34, 48), (48, 48), (49, 2048), (141, 2048),
                                         (2048, 2048), (2049, 0), (0, 0)])
def test_stack_build_for_bound(bound, build):
    """The least of the 8-wide kernels' stacks that holds the tree's bound
    (the mesh-heavy scene's bound, 34, takes the small build); a bound that
    no build holds raises before any launch."""
    assert subpacket.stack_build(bound) == build
    meta8 = torch.zeros((1, 16))
    if build:
        assert subpacket.resolve_stack8(meta8, bound, "subpacket_closest") == bound
    else:
        with pytest.raises(RuntimeError, match="stack deeper"):
            subpacket.resolve_stack8(meta8, bound, "subpacket_closest")


def _degenerate_blocks(seed):
    """Two random triangle blocks (2, 16, 128): padding rows, zero-area and
    sliver triangles among them."""
    rng = np.random.default_rng(seed)
    tris = np.zeros((2, cluster.TRI_COLS, cluster.CLUSTER), np.float32)
    tris[:, 0:9] = rng.normal(0, 3, (2, 9, cluster.CLUSTER))
    tris[:, 9] = rng.random((2, cluster.CLUSTER)) < 0.8  # valid
    tris[:, 10] = rng.random((2, cluster.CLUSTER)) < 0.5  # opaque
    tris[:, 11] = np.arange(2 * cluster.CLUSTER).reshape(2, -1)
    tris[0, 6:9, :16] = tris[0, 3:6, :16]  # e2 = e1: zero area
    tris[1, 6:9, :16] = tris[1, 3:6, :16] * np.float32(1 + 1e-7)  # slivers
    return tris


@pytest.mark.parametrize("case", ["soup700", "soup8000", "deep", "ties", "degenerate"])
def test_direction_rows_equal_origin_rows(case):
    """d' = W d and o' = W (o - v0) share W: both builders write the same
    float32 W[g] into rows 0-2 of group g and rows 4-6 of group g + 3."""
    if case.startswith("soup"):
        tris = cluster_case(int(case[4:]), 1)[6]
    elif case == "deep":
        tris = deep_bvh8()[3]
    elif case == "ties":
        tris = woop_ties_bvh8()[1]
    else:
        tris = _degenerate_blocks(4)
    g = cluster.CLUSTER
    for woop in (subpacket.build_woop_table(tris), subpacket_pallas.build_woop_table(tris)):
        origin, direction = woop[:, 0:3, 0:3 * g], woop[:, 4:7, 3 * g:6 * g]
        np.testing.assert_array_equal(direction.view(np.uint32), origin.view(np.uint32))
        assert np.any(origin != 0.0)


def test_coherence_order_matches_reference():
    """The reference's keys over meta8's scene bounds, sorted stably."""
    _, _, _, _, _, nodes, tris = cluster_case(700, 2)
    slab8, meta8, _ = sub_tables(nodes, tris)
    o, d, t_min, t_max = soup_rays(13, 3e38, 4000)
    t_max[::7] = 0.0  # dead rays: the last key
    lo, hi = meta8[0, 10:13], meta8[0, 13:16]
    keys = np.asarray(subpacket_pallas._coherence_keys(
        *(jnp.asarray(x) for x in (o, d, t_min, t_max, lo, hi - lo))))
    perm = subpacket.coherence_order(*to_torch(o, d, t_min, t_max, meta8)).numpy()
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    assert len(np.unique(keys)) > 100


def test_nan_bary_interaction_recompute(reference, monkeypatch):
    """surface_interaction of the brute-force hits, once with their bary and
    once with bary = NaN and the route on: the same points, and no NaN."""
    monkeypatch.setattr(subpacket, "ENABLED", True)
    positions, triangles, opaque, order, _, _, _ = cluster_case(700, 3)
    n_v = positions.shape[0]
    shade = build_shade_table(
        positions, np.tile(np.float32([[0.0, 0.0, 1.0]]), (n_v, 1)),
        np.zeros((n_v, 2), np.float32), triangles, np.zeros(700, np.int32), order)
    arrays = {"trace": {"shade_table": torch.as_tensor(shade)}}
    o, d, t_min, t_max = soup_rays(11, 3e38, 400)
    ref = trace_closest_brute(brute_geom(positions, triangles, opaque, order),
                              reference_ray(o, d, t_min, t_max))
    prim = torch.tensor(np.asarray(ref.prim))
    hit = Hit(inst=torch.where(prim >= 0, 0, -1).to(torch.int32), prim=prim,
              bary=torch.tensor(np.asarray(ref.bary)), t=torch.tensor(np.asarray(ref.t)))
    ray = Ray(*to_torch(o, d, t_min, t_max))
    it_ref = surface_interaction(arrays, hit, ray)
    it_nan = surface_interaction(arrays, hit._replace(bary=torch.full_like(hit.bary, np.nan)),
                                 ray)
    h = prim.numpy() >= 0
    assert 0.05 < h.mean() < 0.95
    np.testing.assert_allclose(it_nan.p.numpy()[h], it_ref.p.numpy()[h], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(it_nan.uv.numpy()[h], it_ref.uv.numpy()[h], rtol=0, atol=1e-4)
    assert torch.equal(it_nan.valid, it_ref.valid)
    for f in (it_nan.p, it_nan.uv, it_nan.ns):
        assert bool(torch.isfinite(f).all())


def test_trace_closest_routes_to_subpacket(reference, monkeypatch):
    """accel/traverse.py with the route on: the hit's bary is NaN on every
    lane, and its slots and t are the plain version's."""
    monkeypatch.setattr(subpacket, "ENABLED", True)
    _, _, _, _, _, nodes, tris = cluster_case(700, 1)
    o, d, t_min, t_max = to_torch(*soup_rays(7, 3e38, 300))
    slab8, meta8, woop = to_torch(*sub_tables(nodes, tris))
    geom = traverse.TraceGeometry(num_rows=700, cluster_nodes=torch.as_tensor(nodes),
                                  cluster_tris=torch.as_tensor(tris), cluster_woop=woop,
                                  cluster_slab8=slab8, cluster_meta8=meta8)
    hit = traverse.trace_closest(geom, Ray(o, d, t_min, t_max))
    t, slot = subpacket.closest_plain(o, d, t_min, t_max, slab8, meta8, woop)
    assert torch.equal(hit.prim, slot) and torch.equal(hit.t, t)
    assert bool(torch.isnan(hit.bary).all())


@pytest.mark.parametrize("kind,message", [("steps", "pops"), ("stack", "stack deeper"),
                                          ("deep", "stack deeper"), ("index", "out of range")])
def test_plain_walk_raises_on_malformed_tree(kind, message):
    slab8, meta8, stack = malformed_bvh8(kind)
    woop = np.zeros((1, 8, subpacket.WOOP_COLS), np.float32)
    o, d = np.zeros((4, 3), np.float32), np.tile(np.float32([[1.0, 0.0, 0.0]]), (4, 1))
    args = to_torch(o, d, np.zeros(4, np.float32), np.full(4, np.inf, np.float32),
                    slab8, meta8, woop)
    for fn in (subpacket.closest, subpacket.any_hit):
        with pytest.raises(RuntimeError, match=message):
            fn(*args, stack=stack)


def test_render_matches_golden(monkeypatch):
    """The golden is the reference's render on its default (cluster) route."""
    monkeypatch.setattr(subpacket, "ENABLED", True)
    scene = lt.Scene.from_dict(testing.cornell_sphere(resolution=(48, 48), spp=8, depth=5))
    calls = count_calls(monkeypatch, subpacket, cluster)
    img = lt.render(scene, device="cpu")["cornell.exr"]
    bounces = scene.integrator.bounces_run
    assert bounces >= 8 and calls == {
        ("subpacket", "closest"): bounces, ("subpacket", "any_hit"): 0,
        ("cluster", "closest"): 0, ("cluster", "any_hit"): bounces}
    ref = imageio.load_exr(str(SPHERE_GOLDEN))
    assert img.shape == ref.shape and np.all(np.isfinite(img))
    assert float((np.abs(img - ref).max(-1) > 1e-3).mean()) < 0.02
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005
