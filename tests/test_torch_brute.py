"""The port's brute-force trace (luisarender_tpu_torch/ops/brute.py, plain
PyTorch versions on the CPU) against the reference's Pallas kernels
(luisarender_tpu/ops/brute_pallas.py) run in interpret mode, as
tests/test_pallas_trace.py runs them.

Tolerance: slots and occlusion are identical, except on lanes whose two
nearest rows lie within 1e-5 relative in t (a near-tie either side may win);
t agrees within rtol 2e-6, atol 1e-6, and u, v within rtol 2e-6 and an
absolute 1e-6 times the lane's condition number |o - v0| |d x e2| / |det|
(the factor by which Moller-Trumbore amplifies rounding in u's and v's
numerators; it is 2-50 here). The interpreter's XLA CPU code may contract
a*b+c into fused multiply-adds, which the port's plain version (and its
CUDA kernel, built with --fmad=false) does not.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
from luisarender_tpu.core.types import Ray
from luisarender_tpu.ops import brute_pallas
from luisarender_tpu_torch import convert
from luisarender_tpu_torch.ops import brute

N_RAYS = 1000  # not a multiple of the 256-thread block


def _random_geom(n_tris, seed):
    rs = np.random.RandomState(seed)
    centers = rs.randn(n_tris, 3).astype(np.float32) * 3.0
    verts = centers[:, None, :] + rs.randn(n_tris, 3, 3).astype(np.float32) * 0.8
    prim_index = np.arange(n_tris, dtype=np.int32)
    prim_index[rs.choice(n_tris, 3, replace=False)] = -1  # padding rows
    return {
        "tri_v0": verts[:, 0],
        "tri_e1": verts[:, 1] - verts[:, 0],
        "tri_e2": verts[:, 2] - verts[:, 0],
        "prim_index": prim_index,
        "tri_opaque": rs.rand(n_tris) < 0.7,
    }, centers


def _random_rays(n, centers, seed):
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * 6.0).astype(np.float32)
    target = centers[rs.randint(0, centers.shape[0], n)]
    d = target + rs.randn(n, 3).astype(np.float32) * 0.5 - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_min = np.zeros(n, np.float32)
    t_max = np.full(n, np.inf, np.float32)
    kind = rs.randint(0, 4, n)
    t_max[kind == 1] = 0.0  # dead lanes
    t_max[kind == 2] = (rs.rand(int((kind == 2).sum())) * 12.0).astype(np.float32)
    return o, d, t_min, t_max


def _near_tie_lanes(geom, o, d, t_min, t_max):
    """Lanes whose two nearest valid in-range rows lie within 1e-5 relative
    in t (float64 Moller-Trumbore over every row)."""
    v0 = geom["tri_v0"].astype(np.float64)[None]
    e1 = geom["tri_e1"].astype(np.float64)[None]
    e2 = geom["tri_e2"].astype(np.float64)[None]
    o64, d64 = o.astype(np.float64)[:, None], d.astype(np.float64)[:, None]
    p = np.cross(d64, e2)
    det = (e1 * p).sum(-1)
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tv = o64 - v0
    u = (tv * p).sum(-1) * inv
    q = np.cross(tv, e1)
    v = (d64 * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok = (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1 + 1e-6)
    ok &= (geom["prim_index"] >= 0)[None] & (t > t_min[:, None])
    ok &= t < np.minimum(t_max, 3e38)[:, None]
    ts = np.sort(np.where(ok, t, np.inf), axis=-1)
    finite = np.isfinite(ts[:, 1])
    second = np.where(finite, ts[:, 1], 0.0)
    return finite & (second - np.where(finite, ts[:, 0], 0.0) <= 1e-5 * np.abs(second))


def _jax_trace(geom, rays):
    g = SimpleNamespace(**{k: jnp.asarray(v) for k, v in geom.items()})
    r = Ray(*[jnp.asarray(x) for x in rays])
    hit = brute_pallas.trace_closest_pallas(g, r, interpret=True)
    occ = brute_pallas.trace_any_pallas(g, r, interpret=True)
    t = np.asarray(hit.t)
    bary = np.asarray(hit.bary)
    return (t, np.asarray(hit.prim), bary[:, 0], bary[:, 1]), np.asarray(occ)


def _table(geom):
    return brute.make_tri_table(*[torch.as_tensor(geom[k]) for k in (
        "tri_v0", "tri_e1", "tri_e2", "prim_index", "tri_opaque")])


def _port_trace(table, rays):
    args = [torch.as_tensor(x) for x in rays] + [table]
    c0, a0 = brute.closest_launches, brute.any_launches
    closest = [x.numpy() for x in brute.closest(*args)]
    occ = brute.any_hit(*args).numpy()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (brute.closest_launches, brute.any_launches) == (c0, a0)
    return closest, occ


def _condition(geom, o, d, slot):
    """|o - v0| |d x e2| / |det| of each lane's winning row (1 on misses)."""
    s = np.maximum(slot, 0)
    v0, e1, e2 = (geom[k][s].astype(np.float64) for k in ("tri_v0", "tri_e1", "tri_e2"))
    p = np.cross(d.astype(np.float64), e2)
    det = np.abs((e1 * p).sum(-1))
    k = np.linalg.norm(o - v0, axis=-1) * np.linalg.norm(p, axis=-1)
    return np.where(slot >= 0, k / np.maximum(det, 1e-30), 1.0)


def _t_cancellation(geom, o, d, slot):
    """sum |e2_k q_k| / |e2 . q| of each lane's winning row (1 on misses):
    the factor by which the sum in t's numerator amplifies rounding."""
    s = np.maximum(slot, 0)
    v0, e1, e2 = (geom[k][s].astype(np.float64) for k in ("tri_v0", "tri_e1", "tri_e2"))
    terms = e2 * np.cross(o.astype(np.float64) - v0, e1)
    c = np.abs(terms).sum(-1) / np.maximum(np.abs(terms.sum(-1)), 1e-30)
    return np.where(slot >= 0, np.maximum(c, 1.0), 1.0)


def _compare(geom, rays, ref, got, t_scaled=False):
    """t within rtol 2e-6, atol 1e-6; with t_scaled the absolute term is
    1e-6 times the lane's _t_cancellation (for a reference that contracts
    t's numerator into fused multiply-adds)."""
    (t_r, s_r, u_r, v_r), occ_r = ref
    (t_p, s_p, u_p, v_p), occ_p = got
    ties = _near_tie_lanes(geom, *rays)
    assert ties.mean() < 0.01
    np.testing.assert_array_equal(s_p[~ties], s_r[~ties])
    np.testing.assert_array_equal(occ_p[~ties], occ_r[~ties])
    same = s_p == s_r
    if t_scaled:
        both = same & (s_p >= 0)
        np.testing.assert_array_equal(t_p[same & (s_p < 0)], t_r[same & (s_p < 0)])
        c = _t_cancellation(geom, rays[0], rays[1], s_p)[both]
        err = np.abs(t_p[both] - t_r[both])
        assert np.all(err <= 2e-6 * np.abs(t_r[both]) + 1e-6 * c), err.max()
    else:
        np.testing.assert_allclose(t_p[same], t_r[same], rtol=2e-6, atol=1e-6)
    kappa = _condition(geom, rays[0], rays[1], s_p)[same]
    for a, b in ((u_p, u_r), (v_p, v_r)):
        err = np.abs(a[same] - b[same])
        assert np.all(err <= 2e-6 * np.abs(b[same]) + 1e-6 * kappa), err.max()
    miss = s_p < 0
    assert np.all(np.isinf(t_p[miss])) and np.all(u_p[miss] == 0)
    return miss, occ_p


@pytest.fixture(scope="module")
def random_case():
    geom, centers = _random_geom(40, seed=31)
    rays = _random_rays(N_RAYS, centers, seed=32)
    return geom, rays, _jax_trace(geom, rays)


@pytest.fixture(scope="module")
def cornell_case():
    path = Path(__file__).parent.parent / "scenes" / "cornell.json"
    scene = lr.load_scene(str(path))
    compiled = lr.compile_scene(scene)
    arrays = jax.device_get(compiled.arrays)
    geom = {k: np.asarray(arrays["trace"][k]) for k in
            ("tri_v0", "tri_e1", "tri_e2", "prim_index", "tri_opaque")}
    # camera rays of a 32 x 32 crop of the 512^2 view, with sampled filter
    # offsets; half the lanes get a finite t_max (shadow-ray-like)
    rs = np.random.RandomState(33)
    xy = np.stack(np.meshgrid(np.arange(0, 512, 16), np.arange(0, 512, 16)), -1)
    pixel_xy = jnp.asarray(xy.reshape(-1, 2).astype(np.int32))
    u = jnp.asarray(rs.rand(pixel_xy.shape[0], 2).astype(np.float32))
    ray, _, _ = scene.cameras[0].generate_rays(pixel_xy, u, u)
    t_max = np.where(rs.rand(u.shape[0]) < 0.5, np.inf,
                     rs.rand(u.shape[0]) * 1500.0).astype(np.float32)
    rays = (np.asarray(ray.origin), np.asarray(ray.direction),
            np.asarray(ray.t_min), t_max)
    return arrays, compiled.plan, geom, rays, _jax_trace(geom, rays)


def test_tri_table_matches_reference_layout(random_case):
    geom, _, _ = random_case
    ref = brute_pallas.make_tri_table(
        SimpleNamespace(**{k: jnp.asarray(v) for k, v in geom.items()})
    )
    np.testing.assert_array_equal(_table(geom).numpy(), np.asarray(ref))


def test_random_scene_matches_pallas(random_case):
    geom, rays, ref = random_case
    miss, occ = _compare(geom, rays, ref, _port_trace(_table(geom), rays))
    assert 0.05 < (~miss).mean() < 0.95  # both outcomes are exercised
    assert 0.05 < occ.mean() < 0.95


def test_cornell_table_matches_pallas(cornell_case):
    arrays, plan, geom, rays, ref = cornell_case
    tables, _ = convert.convert_tables(
        arrays, [c.impl_names[0] for c in plan.surface_types],
        [c.impl_names[0] for c in plan.light_types],
    )
    # converted tables keep the reference's row order: slots compare directly
    miss, occ = _compare(geom, rays, ref, _port_trace(_table(tables["trace"]), rays))
    assert (~miss[np.isinf(rays[3])]).mean() > 0.9  # the box fills the view
    assert 0.05 < occ.mean() < 0.95


def test_compiled_cornell_table_matches_pallas(cornell_case):
    """The port compiler's own table of the 512^2 Cornell view: its rows are
    in the reference's SAH order, so slots compare directly."""
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch.scene.compiler import SceneCompiler

    from torch_parity import require_reference_builder

    require_reference_builder()
    _, _, geom, rays, ref = cornell_case
    path = Path(__file__).parent.parent / "scenes" / "cornell.json"
    port, _ = SceneCompiler(lt.load_scene(str(path))).compile_numpy()
    np.testing.assert_array_equal(port["trace"]["prim_index"], geom["prim_index"])
    miss, occ = _compare(geom, rays, ref, _port_trace(_table(port["trace"]), rays))
    assert (~miss[np.isinf(rays[3])]).mean() > 0.9


def test_plain_closest_strict_tie_takes_lowest_row():
    """Rows 1 and 2 are the same triangle: the strict t < best_t keeps row 1;
    row 0 lies off the ray and row 3 is an invalid copy in front of it."""
    tri = np.float32([[0, 0, 5], [1, 0, 0], [0, 1, 0]])  # v0, e1, e2
    off = np.float32([[9, 9, 5], [1, 0, 0], [0, 1, 0]])
    near = np.float32([[0, 0, 2], [1, 0, 0], [0, 1, 0]])
    rows = np.stack([off, tri, tri, near])
    geom = {"tri_v0": rows[:, 0], "tri_e1": rows[:, 1], "tri_e2": rows[:, 2],
            "prim_index": np.int32([0, 1, 2, -1]), "tri_opaque": np.ones(4, bool)}
    o = torch.tensor([[0.25, 0.25, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    t, slot, u, v = brute.closest(o, d, torch.zeros(1), torch.full((1,), np.inf),
                                  _table(geom))
    assert (int(slot[0]), float(t[0]), float(u[0]), float(v[0])) == (1, 5.0, 0.25, 0.25)


GENERAL_SPHERE = {"impl": "sphere", "prop": {
    "analytic": False, "subdivision": 2, "surface": {"impl": "matte", "prop": {}},
    "transform": {"impl": "srt", "prop": {"scale": [100, 100, 100],
                                          "translate": [400, 100, 300]}}}}


def test_general_scene_two_bounces_match_reference():
    """The general fork's brute-force table at its real shape: the 352 rows
    of testing.cornell_box plus a subdivided icosphere, compiled by the
    reference and carried over by convert.py, against 32 x 32 camera rays,
    bounce-1 rays from their hits (random directions; lanes whose camera ray
    missed are dead) and shadow rays from both sets of hits toward the
    light. The reference here is its XLA fallback
    (luisarender_tpu/accel/traverse.py trace_closest_brute /
    trace_any_brute): its Pallas kernel in interpret mode takes minutes to
    compile at 352 rows. The fallback packs a row's chunk-local index into
    t's low bits; 32-row chunks keep that within the near-tie window (t
    within 2^-18 relative, under 1e-5). Its recompute of the winner's t
    contracts into fused multiply-adds, which on a lane whose numerator
    cancels (its three terms ~35x their sum) moves t by 2.5e-6 of 3.1
    against the port's 5e-7 of float64's value; t's absolute term is
    therefore scaled by that cancellation, as u's and v's are by their
    condition number (_compare's t_scaled)."""
    from luisarender_tpu import testing as jtesting
    from luisarender_tpu.accel import traverse

    d = jtesting.cornell_box(resolution=(512, 512), spp=1, depth=8)
    d["render"]["shapes"].append(GENERAL_SPHERE)
    scene = lr.Scene.from_dict(d)
    compiled = lr.compile_scene(scene)
    arrays = jax.device_get(compiled.arrays)
    geom = {k: np.asarray(arrays["trace"][k]) for k in
            ("tri_v0", "tri_e1", "tri_e2", "prim_index", "tri_opaque")}
    assert geom["tri_v0"].shape[0] == 352
    tables, _ = convert.convert_tables(
        arrays, [c.impl_names[0] for c in compiled.plan.surface_types],
        [c.impl_names[0] for c in compiled.plan.light_types],
    )
    table = _table(tables["trace"])
    g = SimpleNamespace(**{k: jnp.asarray(v) for k, v in geom.items()})

    def reference(rays):
        r = Ray(*[jnp.asarray(x) for x in rays])
        hit = traverse.trace_closest_brute(g, r, chunk=32)
        bary = np.asarray(hit.bary)
        return ((np.asarray(hit.t), np.asarray(hit.prim), bary[:, 0], bary[:, 1]),
                np.asarray(traverse.trace_any_brute(g, r)))

    rs = np.random.RandomState(34)
    xy = np.stack(np.meshgrid(np.arange(0, 512, 16), np.arange(0, 512, 16)), -1)
    pixel_xy = jnp.asarray(xy.reshape(-1, 2).astype(np.int32))
    u = jnp.asarray(rs.rand(pixel_xy.shape[0], 2).astype(np.float32))
    ray, _, _ = scene.cameras[0].generate_rays(pixel_xy, u, u)
    n = pixel_xy.shape[0]
    rays = (np.asarray(ray.origin), np.asarray(ray.direction), np.asarray(ray.t_min),
            np.full(n, np.inf, np.float32))
    light = np.float32([278.0, 548.0, 280.0])
    for bounce in range(2):
        got = _port_trace(table, rays)
        _compare(geom, rays, reference(rays), got, t_scaled=True)
        t, slot = got[0][0], got[0][1]
        live = rays[2] < rays[3]
        assert (slot[live] >= 0).mean() > 0.3  # the box is open at the front
        hit = slot >= 0
        p = np.where(hit[:, None], rays[0] + np.where(hit, t, 0.0)[:, None] * rays[1], 0.0)
        p = p.astype(np.float32)
        # shadow rays from the hits toward the light's area
        target = light + rs.uniform(-50.0, 50.0, (n, 3)).astype(np.float32) * [1, 0, 1]
        to = target - p
        dist = np.linalg.norm(to, axis=-1)
        shadow = (p, (to / np.maximum(dist, 1e-6)[:, None]).astype(np.float32),
                  np.full(n, 0.05, np.float32), np.where(hit, dist * 0.999, 0.0).astype(np.float32))
        _, occ_s = _compare(geom, shadow, reference(shadow), _port_trace(table, shadow),
                            t_scaled=True)
        assert 0.01 < occ_s[hit].mean() < 0.99
        # the next bounce: random directions from the hits, misses dead
        dirs = rs.randn(n, 3).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        rays = (p, dirs, np.full(n, 0.05, np.float32),
                np.where(hit, np.inf, 0.0).astype(np.float32))
