"""The CUDA kernels of luisarender_tpu_torch/csrc held against their plain
PyTorch versions, on a CUDA card: the brute-force traces (brute.cu against
ops/brute.py), the cluster traces (cluster.cu against ops/cluster.py
walk_plain), the 8-wide traces (wide8.cu and subpacket.cu against
ops/wide8.py wide8_plain and ops/subpacket.py subpacket_plain), the
binary-tree trace (trace.cu against ops/trace.py walk_plain) and the fused
whole-path kernel (fused_path.cu against ops/fused_path.py paths_plain),
its environment mode (on constant maps and on the Nishita sky and an EXR
sun map, whose alias tables the candidates sample) and ray-input mode
included; the cluster traces on a megavpt sample of scenes/fog.json (the
scatter events' shadow rays start inside 5,120 non-opaque triangles), and
megavpt's 32^2 renders on the card against their goldens.

Marked `gpu`; every test skips where no card is present. On a machine with
a card and without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(--noconftest: tests/conftest.py configures JAX for the CPU suite.)

Kernel and plain version do the same IEEE float32 operations in the same
order (nvcc --fmad=false, no fast math), so the traces must agree
exactly: slots and occlusion bit for bit, and t / u / v bit for bit too
(the tree walks' per-ray pop, leaf and row counts as well, and the
cluster walk's in caller order and sorted alike). The fused
kernel's paths too: rgb and ray counts bit for bit on every lane (its
sinf / cosf / powf / expf / logf are the same CUDA functions that PyTorch's
kernels call on the card).
"""

import math

import numpy as np
import pytest
import torch

from luisarender_tpu_torch.ops import brute

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _random_table(p, seed, n_invalid=3):
    rs = np.random.RandomState(seed)
    centers = rs.randn(p, 3).astype(np.float32) * 4.0
    verts = centers[:, None, :] + rs.randn(p, 3, 3).astype(np.float32)
    v0 = verts[:, 0]
    table = np.zeros((p, brute.TRI_COLS), np.float32)
    table[:, 0:3] = v0
    table[:, 3:6] = verts[:, 1] - v0
    table[:, 6:9] = verts[:, 2] - v0
    table[:, 9] = 1.0
    table[rs.choice(p, n_invalid, replace=False), 9] = 0.0  # padding rows
    table[:, 10] = (rs.rand(p) < 0.7).astype(np.float32)  # opaque
    return table, centers


def _random_rays(n, centers, seed):
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * 8.0).astype(np.float32)
    target = centers[rs.randint(0, centers.shape[0], n)]
    d = target + rs.randn(n, 3).astype(np.float32) * 0.7 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.zeros(n, np.float32)
    t_max = np.full(n, np.inf, np.float32)
    kind = rs.randint(0, 4, n)
    t_max[kind == 1] = 0.0  # dead lanes
    t_max[kind == 2] = rs.rand(int((kind == 2).sum())).astype(np.float32) * 20.0
    return o, d.astype(np.float32), t_min, t_max


def _to(dev, *arrays):
    return [torch.as_tensor(a, device=dev).contiguous() for a in arrays]


def _assert_same(kernel, plain):
    for k, p in zip(kernel, plain):
        assert torch.equal(k, p), (k != p).nonzero()[:5]


@pytest.mark.parametrize("p,n,seed", [(40, 1000, 1), (512, 262_144 + 77, 2)],
                         ids=["p40_ragged", "p512_full"])
def test_closest_and_any_match_plain(cuda, p, n, seed):
    table, centers = _random_table(p, seed)
    o, d, t_min, t_max = _to(cuda, *_random_rays(n, centers, seed + 100))
    tab = _to(cuda, table)[0]
    c0, a0 = brute.closest_launches, brute.any_launches
    kern = brute.closest(o, d, t_min, t_max, tab)
    occ = brute.any_hit(o, d, t_min, t_max, tab)
    torch.cuda.synchronize()
    assert (brute.closest_launches, brute.any_launches) == (c0 + 1, a0 + 1)
    plain = brute.closest_plain(o, d, t_min, t_max, tab)
    _assert_same(kern, plain)
    assert torch.equal(occ, brute.any_plain(o, d, t_min, t_max, tab))
    # the scene is dense enough that both answers are exercised
    hit = kern[1] >= 0
    assert 0.05 < hit.float().mean().item() < 0.95
    assert torch.all(torch.isinf(kern[0][~hit])) and torch.all(kern[2][~hit] == 0)
    assert 0.05 < occ.float().mean().item() < 0.95


def test_cornell_camera_rays_match_plain(cuda):
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch import testing

    scene = lt.Scene.from_dict(testing.cornell_box(resolution=(128, 128), spp=1))
    compiled = lt.compile_scene(scene, device=cuda)
    cam = scene.cameras[0]
    ys, xs = torch.meshgrid(torch.arange(128, device=cuda),
                            torch.arange(128, device=cuda), indexing="ij")
    pixel_xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.int32)
    u = torch.rand((pixel_xy.shape[0], 2), device=cuda,
                   generator=torch.Generator(cuda).manual_seed(3))
    ray, _, _ = cam.generate_rays(pixel_xy, u, u)
    tab = compiled.arrays["trace"]["tri_table"]
    args = (ray.origin, ray.direction, ray.t_min, ray.t_max, tab)
    kern = brute.closest(*args)
    _assert_same(kern, brute.closest_plain(*args))
    assert (kern[1] >= 0).float().mean().item() > 0.9  # the box fills the view
    short = ray.t_max.new_full(ray.t_max.shape, 1e3)
    args = (ray.origin, ray.direction, ray.t_min, short, tab)
    assert torch.equal(brute.any_hit(*args), brute.any_plain(*args))


def test_wrappers_reject_bad_inputs(cuda):
    table, centers = _random_table(8, 5, n_invalid=0)
    o, d, t_min, t_max = _to(cuda, *_random_rays(64, centers, 6))
    tab = _to(cuda, table)[0]
    with pytest.raises(TypeError):
        brute.closest(o.double(), d, t_min, t_max, tab)
    with pytest.raises(ValueError):
        brute.closest(o, d, t_min, t_max, tab.repeat(65, 1))  # 520 rows
    with pytest.raises(ValueError):
        brute.any_hit(o.t().contiguous().t(), d, t_min, t_max, tab)
    with pytest.raises(ValueError):
        brute.any_hit(o.cpu(), d, t_min, t_max, tab)
    t, slot, u, v = brute.closest(o[:0], d[:0], t_min[:0], t_max[:0], tab)
    assert slot.shape == (0,)
    assert math.isfinite(float(u.sum()))


_GENERAL = {}


def _general_case(cuda):
    """The general fork's brute-force table (testing.cornell_box plus a
    subdivided icosphere: 352 rows) and the 512^2 view's camera rays, with
    t_max drawn finite on half the lanes (so that shadow-like rays both
    pass and stop); built once per test process."""
    if not _GENERAL:
        import luisarender_tpu_torch as lt
        from luisarender_tpu_torch import testing

        d = testing.cornell_box(resolution=(512, 512), spp=1, depth=8)
        d["render"]["shapes"].append({"impl": "sphere", "prop": {
            "analytic": False, "subdivision": 2, "surface": {"impl": "matte", "prop": {}},
            "transform": {"impl": "srt", "prop": {"scale": [100, 100, 100],
                                                  "translate": [400, 100, 300]}}}})
        scene = lt.Scene.from_dict(d)
        compiled = lt.compile_scene(scene, device=cuda)
        ys, xs = torch.meshgrid(torch.arange(512, device=cuda),
                                torch.arange(512, device=cuda), indexing="ij")
        pixel_xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.int32)
        rs = np.random.RandomState(11)
        u = torch.as_tensor(rs.rand(512 * 512, 2).astype(np.float32), device=cuda)
        ray, _, _ = scene.cameras[0].generate_rays(pixel_xy, u, u)
        t_max = np.where(rs.rand(512 * 512) < 0.5, np.inf,
                         rs.rand(512 * 512) * 1500.0).astype(np.float32)
        _GENERAL.update(table=compiled.arrays["trace"]["tri_table"],
                        rays=(ray.origin.contiguous(), ray.direction.contiguous(),
                              ray.t_min.contiguous(), torch.as_tensor(t_max, device=cuda)))
    return _GENERAL["table"], _GENERAL["rays"]


def _both_match_plain(args):
    """One launch of each kernel on args, bit for bit against the plain
    versions; returns (closest outputs, occlusion)."""
    c0, a0 = brute.closest_launches, brute.any_launches
    kern = brute.closest(*args)
    occ = brute.any_hit(*args)
    torch.cuda.synchronize()
    assert (brute.closest_launches, brute.any_launches) == (c0 + 1, a0 + 1)
    _assert_same(kern, brute.closest_plain(*args))
    assert occ.dtype == torch.bool
    assert torch.equal(occ, brute.any_plain(*args))
    return kern, occ


@pytest.mark.parametrize("live", [1.0, 0.25, 0.03, 0.0], ids=["live100", "live25", "live3",
                                                               "live0"])
def test_general_table_live_shares_match_plain(cuda, live):
    """The 352-row table at the general fork's shares of live lanes, dead
    lanes (t_max = 0) scattered at random."""
    table, (o, d, t_min, t_max) = _general_case(cuda)
    assert table.shape[0] == 352
    dead = torch.as_tensor(np.random.RandomState(12).rand(o.shape[0]) >= live, device=cuda)
    t_max = torch.where(dead, 0.0, t_max)
    kern, occ = _both_match_plain((o, d, t_min, t_max, table))
    hit = kern[1] >= 0
    assert int(hit.sum()) == int((hit & ~dead).sum())  # dead lanes miss
    assert not bool(occ[dead].any())
    if live == 1.0:
        assert hit[torch.isinf(t_max)].float().mean().item() > 0.9  # the box fills the view
        assert 0.01 < occ.float().mean().item() < 0.99


@pytest.mark.parametrize("n", [1, 31, 33, 262_144 - 77])
def test_general_table_ragged_counts_match_plain(cuda, n):
    table, rays = _general_case(cuda)
    _both_match_plain(tuple(x[:n].contiguous() for x in rays) + (table,))


def test_duplicated_rows_tie_to_the_lower_row(cuda):
    """The first 256 rows of the 352-row table twice over (512 rows): every
    hit is an exact tie between a row and its copy, and goes to the lower."""
    table, rays = _general_case(cuda)
    tab = torch.cat([table[:256], table[:256]]).contiguous()
    kern, _ = _both_match_plain(rays + (tab,))
    hit = kern[1] >= 0
    assert hit.float().mean().item() > 0.3
    assert int(kern[1].max()) < 256


@pytest.mark.parametrize("where", [0, -1], ids=["first_row", "last_row"])
def test_only_occluder_in_first_or_last_row(cuda, where):
    """Any-hit over a 352-row table whose only opaque row, a wall in front
    of every ray, is the first or the last row."""
    table, (o, d, t_min, _) = _general_case(cuda)
    tab = table.clone()
    tab[:, 10] = 0.0
    wall = torch.tensor([-1e4, -1e4, 1.0, 4e4, 0.0, 0.0, 0.0, 4e4, 0.0], device=cuda)
    o = torch.zeros_like(o)
    d = torch.nn.functional.normalize(torch.cat([0.1 * d[:, :2], torch.ones_like(d[:, :1])], -1),
                                      dim=-1)  # every ray meets the wall at z = 1
    tab[where, :9] = wall
    tab[where, 9:11] = 1.0
    t_max = torch.full_like(t_min, 1e3)
    t_max[::7] = 0.0  # dead lanes
    _, occ = _both_match_plain((o.contiguous(), d.contiguous(), t_min, t_max, tab))
    assert bool(occ[t_max > 0].all()) and not bool(occ[t_max == 0].any())


def test_invalid_and_clear_rows_match_plain(cuda):
    """Rows with valid = 0 (a padding row: closest skips it) or opaque = 0
    (any-hit skips it), a third each, mixed through the 352-row table."""
    table, rays = _general_case(cuda)
    tab = table.clone()
    kind = torch.as_tensor(np.random.RandomState(13).randint(0, 3, tab.shape[0]), device=cuda)
    tab[kind == 1, 9] = 0.0
    tab[kind == 2, 10] = 0.0
    kern, occ = _both_match_plain(rays + (tab,))
    assert not bool((kind[kern[1][kern[1] >= 0].long()] == 1).any())
    assert 0.01 < occ.float().mean().item() < 0.99


def test_brute_counters(cuda):
    """The lane counters of one launch each: every live ray counted once,
    closest testing every valid row, any-hit at most every opaque one, and
    lane-slots at least the tests; counting leaves the outputs as they are."""
    table, (o, d, t_min, t_max) = _general_case(cuda)
    t_max = torch.where(torch.arange(o.shape[0], device=cuda) % 4 == 0, t_max, 0.0)
    args = (o, d, t_min, t_max, table)
    live = int((t_min < torch.clamp(t_max, max=3e38)).sum())
    for fn, plain in ((brute.closest, brute.closest_plain), (brute.any_hit, brute.any_plain)):
        ctr = torch.zeros(len(brute.COUNTERS), dtype=torch.int64, device=cuda)
        out = fn(*args, counters=ctr)
        c = dict(zip(brute.COUNTERS, ctr.tolist()))
        want = plain(*args)
        if fn is brute.closest:
            _assert_same(out, want)
            assert c["tests"] == live * table.shape[0]
        else:
            assert torch.equal(out, want)
            assert 0 < c["tests"] <= live * table.shape[0]
        assert c["rays"] == live
        assert c["tests"] <= c["slots"] and c["deep_slots"] <= c["slots"]
    with pytest.raises(ValueError):
        brute.closest(*args, counters=torch.zeros(3, dtype=torch.int64, device=cuda))


def _cluster_case(cuda, n_tris, n_rays, seed, copies=1):
    """A soup of n_tris triangles, each `copies` times (the same vertices:
    exact ties in t, across clusters where a triangle's copies fill more
    than one), its cluster tables and rays through it."""
    from luisarender_tpu_torch.ops import cluster
    from torch_parity import soup

    positions, triangles = soup(n_tris, seed)
    triangles = np.repeat(triangles, copies, axis=0)
    n_tris *= copies
    rs = np.random.RandomState(seed)
    opaque = rs.rand(n_tris) < 0.7
    nodes, tris = cluster.build_cluster_tables(positions, triangles, opaque,
                                               rs.permutation(n_tris))
    o = rs.uniform(-0.5, 1.5, (n_rays, 3)).astype(np.float32)
    d = rs.randn(n_rays, 3).astype(np.float32)
    if copies > 1:  # half the rays aimed at a triangle, so that ties occur
        aim = positions[triangles[rs.randint(0, n_tris, n_rays // 2)]].mean(axis=1)
        d[: n_rays // 2] = aim - o[: n_rays // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.full(n_rays, 1e-4, np.float32)
    t_max = np.where(rs.rand(n_rays) < 0.5, np.inf, rs.rand(n_rays) * 2.0).astype(np.float32)
    t_max[rs.rand(n_rays) < 0.1] = 0.0  # dead lanes
    return cluster, _to(cuda, o, d, t_min, t_max, nodes, tris)


def _launch_sorted(cluster):
    """cluster.launch on the rays in the reference's coherence order
    (cluster.coherence_order), its outputs and walk counts scattered back
    to caller order: the route of the reference's wrapper."""
    def launch(o, d, t_min, t_max, nodes, tris, any_hit, err, stats=None):
        perm = cluster.coherence_order(o, d, t_min, t_max, nodes)
        rays = [x.index_select(0, perm) for x in (o, d, t_min, t_max)]
        walk = None if stats is None else torch.empty_like(stats)
        out = cluster.launch(*rays, nodes, tris, any_hit, err, walk)
        if stats is not None:
            stats[perm] = walk
        back = []
        for x in out if isinstance(out, tuple) else (out,):
            y = torch.empty_like(x)
            y[perm] = x
            back.append(y)
        return tuple(back) if isinstance(out, tuple) else back[0]
    return launch


def _cluster_walks_match(cluster, args, cuda, launch, want, any_hit):
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = torch.zeros_like(want)
    launch(*args, any_hit, err, got)
    torch.cuda.synchronize()
    assert int(err.item()) == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_tris,n_rays,copies", [(100, 1000, 1), (3000, 100_003, 1),
                                                  (20, 20_000, 6), (60, 100_003, 200)],
                         ids=["one_cluster", "t3000_ragged", "coincident_one_cluster",
                              "coincident_across_clusters"])
def test_cluster_kernel_matches_plain(cuda, n_tris, n_rays, copies):
    """Both modes bit-equal with walk_plain, the per-ray walk counts too, in
    caller order (`launch`, the wrappers' route) and in the reference's
    coherence order (`_launch_sorted`); coincident triangles tie exactly,
    inside a cluster and across clusters."""
    cluster, args = _cluster_case(cuda, n_tris, n_rays, 11, copies)
    c0, a0 = cluster.closest_launches, cluster.any_launches
    kern = cluster.closest(*args)
    occ = cluster.any_hit(*args)
    torch.cuda.synchronize()
    assert (cluster.closest_launches, cluster.any_launches) == (c0 + 1, a0 + 1)
    t, slot, u, v, _, stats = cluster.walk_plain(*args, False)
    _assert_same(kern, (t, slot, u, v))
    occ_p, stats_any = cluster.walk_plain(*args, True)[4:]
    assert torch.equal(occ, occ_p)
    hit = kern[1] >= 0  # both answers are exercised
    assert 0.01 < hit.float().mean().item() < 0.95
    assert 0.01 < occ.float().mean().item() < 0.95
    # the walks themselves: the same pops, leaf visits and rows per ray
    for any_hit, want in ((False, stats), (True, stats_any)):
        for launch in (cluster.launch, _launch_sorted(cluster)):
            _cluster_walks_match(cluster, args, cuda, launch, want, any_hit)
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    _assert_same(_launch_sorted(cluster)(*args, False, err), (t, slot, u, v))
    assert torch.equal(_launch_sorted(cluster)(*args, True, err) > 0, occ_p)


@pytest.mark.parametrize("n,dead", [(1, None), (45, None), (96, slice(32, 64)),
                                    (40_000, slice(0, 40_000, 3))],
                         ids=["one_ray", "n45", "dead_warp", "n40000_third_dead"])
def test_cluster_kernel_ragged_and_dead(cuda, n, dead):
    """Ray counts that leave a warp part-filled, a warp whose rays are all
    dead, a single ray, and more rays than the reference's sort threshold
    (32,768), in caller order and sorted: every output and walk count
    bit-equal with walk_plain, one launch a call."""
    cluster, args = _cluster_case(cuda, 3000, max(n, 64), 17)
    args = [x[:n].contiguous() for x in args[:4]] + list(args[4:])
    if dead is not None:
        args[3][dead] = 0.0
    c0, a0 = cluster.closest_launches, cluster.any_launches
    kern = cluster.closest(*args)
    occ = cluster.any_hit(*args)
    torch.cuda.synchronize()
    assert (cluster.closest_launches, cluster.any_launches) == (c0 + 1, a0 + 1)
    t, slot, u, v, _, stats = cluster.walk_plain(*args, False)
    _assert_same(kern, (t, slot, u, v))
    occ_p, stats_any = cluster.walk_plain(*args, True)[4:]
    assert torch.equal(occ, occ_p)
    if dead is not None:
        assert torch.all(stats[dead] == 0) and torch.all(kern[1][dead] == -1)
    for any_hit, want in ((False, stats), (True, stats_any)):
        for launch in (cluster.launch, _launch_sorted(cluster)):
            _cluster_walks_match(cluster, args, cuda, launch, want, any_hit)


def test_cluster_kernel_counters(cuda):
    """The kernel's lane counters agree with the walk counts they sum."""
    cluster, args = _cluster_case(cuda, 3000, 10_007, 18)
    for any_hit in (False, True):
        err = torch.zeros(1, dtype=torch.int32, device=cuda)
        stats = torch.zeros((10_007, 3), dtype=torch.int32, device=cuda)
        ctr = torch.zeros(len(cluster.COUNTERS), dtype=torch.int64, device=cuda)
        cluster.launch(*args, any_hit, err, stats, ctr)
        torch.cuda.synchronize()
        c = dict(zip(cluster.COUNTERS, ctr.tolist()))
        assert c["pops"] == int(stats[:, 0].sum()) <= c["pop_slots"]
        assert c["parked"] == int(stats[:, 1].sum())
        assert c["rows"] == int(stats[:, 2].sum()) <= c["row_slots"]
        assert 0 < c["rounds"] <= c["parked"] and 0 < c["loads"] <= c["parked"]


def test_cluster_wrappers_raise_on_bad_inputs_and_trees(cuda):
    cluster, (o, d, t_min, t_max, nodes, tris) = _cluster_case(cuda, 700, 256, 12)
    with pytest.raises(TypeError):
        cluster.closest(o.double(), d, t_min, t_max, nodes, tris)
    with pytest.raises(ValueError):
        cluster.any_hit(o, d, t_min, t_max, nodes[:, :6].contiguous(), tris)
    with pytest.raises(ValueError):
        cluster.closest(o.cpu(), d, t_min, t_max, nodes, tris)
    t, slot, u, v = cluster.closest(o[:0], d[:0], t_min[:0], t_max[:0], nodes, tris)
    assert slot.shape == (0,) and cluster.any_hit(o[:0], d[:0], t_min[:0], t_max[:0],
                                                  nodes, tris).shape == (0,)
    # a node table whose walk never ends: the error word, then a raise
    box = [-10.0, -10.0, -10.0, 10.0, 10.0, 10.0]
    loop = torch.tensor([box + [0.0, -1.0], box + [-1.0, 0.0]], device=cuda)
    ray = torch.zeros((4, 3), device=cuda)
    x = torch.tensor([[1.0, 0.0, 0.0]], device=cuda).repeat(4, 1)
    args = (ray, x, torch.zeros(4, device=cuda), torch.full((4,), math.inf, device=cuda),
            loop, tris[:1].contiguous())
    for fn in (cluster.closest, cluster.any_hit):
        with pytest.raises(RuntimeError, match="pops"):
            fn(*args)
    # a caller's error word: set, not read, by the launch; read once by
    # check_error; a word off the card is refused
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    for fn, any_hit in ((cluster.closest, False), (cluster.any_hit, True)):
        fn(*args, err)
        assert int(err.item()) != 0
        with pytest.raises(RuntimeError, match="pops"):
            cluster.check_error(err, any_hit)
        err.zero_()
        with pytest.raises(ValueError, match="err"):
            fn(*args, err.cpu())


def _fused_case(cuda, path, res, depth):
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid
    from luisarender_tpu_torch.ops import fused_path

    scene = lt.load_scene(path)
    compiled = lt.compile_scene(scene, device=cuda)
    assert compiled.plan.fused_path
    cam = fused_path.camgen_params(scene.cameras[0], scene.integrator.sampler.seed)
    w, h = scene.cameras[0].film.resolution
    pxy = pixel_grid(w, h, cuda)[:: (w * h) // (res * res)].contiguous()
    kw = dict(max_depth=depth, rr_depth=0, rr_threshold=0.95)
    return fused_path, fused_path.fused_tables(compiled), cam, pxy, kw


def _equal_to_plain(fp, tables, cam, pxy, si, ns, kw):
    rgb, rays = fp.paths(tables, cam, pxy, si, ns, **kw)
    torch.cuda.synchronize()
    rgb_p, rays_p = fp.paths_plain(tables, cam, pxy, si, ns, **kw)
    assert torch.equal(rgb, rgb_p), ((rgb != rgb_p).any(-1).float().mean().item(),
                                     (rgb - rgb_p).abs().max().item())
    assert torch.equal(rays, rays_p), int((rays != rays_p).sum())
    return rgb, rays


@pytest.mark.parametrize("scene,depth", [("cornell", 8), ("materials", 10)])
def test_fused_kernel_matches_plain(cuda, scene, depth):
    """Every lane bit-equal with the plain version, rgb and ray counts, in
    both modes, on a permuted pixel list; the persistent pass within 1e-6
    of the sum of its samples' one-sample launches."""
    fp, tables, cam, pxy, kw = _fused_case(cuda, f"scenes/{scene}.json", 128, depth)
    perm = torch.randperm(pxy.shape[0], generator=torch.Generator().manual_seed(5))
    pxy = pxy[perm.to(cuda)].contiguous()
    n0, p0 = fp.launches, fp.persistent_launches
    rgb, _ = _equal_to_plain(fp, tables, cam, pxy, 3, 0, kw)
    assert torch.isfinite(rgb).all() and rgb.mean().item() > 0.0
    rgb4, _ = _equal_to_plain(fp, tables, cam, pxy, 3, 4, kw)
    assert (fp.launches, fp.persistent_launches) == (n0 + 1, p0 + 1)
    tot = sum(fp.paths(tables, cam, pxy, 3 + s, **kw)[0] for s in range(4))
    assert torch.allclose(rgb4, tot, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [1, 127, 129, 300, 262_144 - 5],
                         ids=["n1", "n127", "n129", "under_one_pool", "over_one_wave"])
def test_fused_kernel_ragged_counts(cuda, n):
    """Lane counts that leave blocks, warps and slot pools part-filled (300:
    fewer than one block's slots), and more lanes than the card holds slots
    at once: every lane bit-equal with the plain version in both modes."""
    fp, tables, cam, pxy, kw = _fused_case(cuda, "scenes/materials.json", 512, 3)
    idx = torch.randperm(pxy.shape[0], generator=torch.Generator().manual_seed(n))[:n]
    sub = pxy[idx.to(cuda)].contiguous()
    for ns in (0, 2):
        _equal_to_plain(fp, tables, cam, sub, 1, ns, kw)


def test_fused_kernel_back_to_back_launches(cuda):
    """Launches queued on one stream without a synchronise between them give
    the same lanes: each launch starts its work counter at 0."""
    fp, tables, cam, pxy, kw = _fused_case(cuda, "scenes/cornell.json", 256, 4)
    stats = torch.zeros(len(fp.STATS), dtype=torch.int64, device=cuda)
    outs = [fp.paths(tables, cam, pxy, 1, ns, stats=stats, **kw) for ns in (0, 0, 2, 2)]
    torch.cuda.synchronize()
    for a, b in ((outs[0], outs[1]), (outs[2], outs[3])):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    rgb_p, rays_p = fp.paths_plain(tables, cam, pxy, 1, 0, **kw)
    assert torch.equal(outs[0][0], rgb_p) and torch.equal(outs[0][1], rays_p)
    c = dict(zip(fp.STATS, stats.tolist()))
    assert 0 < c["shaded"] <= c["traced"] <= c["lane_slots"] and c["rounds"] > 0


def test_fused_wrapper_rejects_bad_inputs(cuda):
    fp, tables, cam, pxy, kw = _fused_case(cuda, "scenes/cornell.json", 16, 2)
    with pytest.raises(ValueError):
        fp.paths(tables, cam, pxy.long(), 0, **kw)
    with pytest.raises(ValueError):
        fp.paths(tables, cam, pxy.cpu(), 0, **kw)
    with pytest.raises(ValueError):
        fp.paths(tables._replace(inst=tables.inst.repeat(6, 1)), cam, pxy, 0, **kw)
    with pytest.raises(ValueError):
        fp.paths(tables, cam, pxy, 0, stats=torch.zeros(len(fp.STATS), device=cuda), **kw)
    rgb, rays = fp.paths(tables, cam, pxy[:0], 0, **kw)
    assert rgb.shape == (0, 3) and rays.shape == (0,)


def _fused_env_case(cuda, kind, res, depth):
    """testing.cornell_box with an environment (chip_smoke.py env_scene) and
    its environment-mode inputs on a permuted pixel list."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid
    from luisarender_tpu_torch.ops import fused_path as fp

    scene = chip_smoke.env_scene(lt, kind, res=res, depth=depth)
    compiled = lt.compile_scene(scene, device=cuda)
    assert compiled.plan.fused_path and compiled.plan.has_environment
    integ = scene.integrator
    cam = fp.camgen_params(scene.cameras[0], integ.sampler.seed)
    pxy = pixel_grid(res, res, cuda)
    perm = torch.randperm(pxy.shape[0], generator=torch.Generator().manual_seed(res))
    pxy = pxy[perm.to(cuda)].contiguous()
    kw = dict(max_depth=depth, rr_depth=0, rr_threshold=0.95)
    p_env = integ.light_sampler.selection_probs(compiled)[0]
    env = fp.EnvInputs(fp.env_nee_candidates(compiled, cam, pxy, 2, depth, p_env), p_env,
                       compiled.plan.env_distance)
    return fp, compiled, fp.fused_tables(compiled), cam, pxy, kw, env


@pytest.mark.parametrize("kind", ["spherical", "directional", "env_only", "nishitasky", "image"])
def test_fused_env_mode_matches_plain(cuda, kind):
    """The environment mode: rgb, rays and the 7 escape words bit for bit
    on every lane of a permuted pixel list, one launch counted as an
    environment launch; the miss pass lights the escaped pixels."""
    fp, compiled, tables, cam, pxy, kw, env = _fused_env_case(cuda, kind, 128, 6)
    n0, e0 = fp.launches, fp.env_launches
    rgb, rays, esc = fp.paths(tables, cam, pxy, 2, 0, env=env, **kw)
    torch.cuda.synchronize()
    assert (fp.launches, fp.env_launches) == (n0, e0 + 1)
    rgb_p, rays_p, esc_p = fp.paths_plain(tables, cam, pxy, 2, 0, env=env, **kw)
    assert torch.equal(rgb, rgb_p), (rgb - rgb_p).abs().max().item()
    assert torch.equal(rays, rays_p)
    assert torch.equal(esc, esc_p), (esc - esc_p).abs().max().item()
    escaped = esc[3] > 0.0
    assert bool(escaped.any())
    out = fp.miss_pass(compiled, rgb, esc, env.p_env)
    assert torch.isfinite(out).all() and bool((out[escaped] >= rgb[escaped]).all())


@pytest.mark.parametrize("n", [1, 129, 300], ids=["n1", "n129", "under_one_pool"])
def test_fused_env_mode_ragged_counts(cuda, n):
    """Part-filled blocks, warps and slot pools: the candidates and escape
    words are read and written at the pixel's index, never the slot's."""
    fp, compiled, tables, cam, pxy, kw, env = _fused_env_case(cuda, "spherical", 64, 4)
    idx = torch.randperm(pxy.shape[0], generator=torch.Generator().manual_seed(n))[:n].to(cuda)
    sub = pxy[idx].contiguous()
    env_sub = env._replace(cand=env.cand[:, :, idx].contiguous())
    out = fp.paths(tables, cam, sub, 2, 0, env=env_sub, **kw)
    torch.cuda.synchronize()
    ref = fp.paths_plain(tables, cam, sub, 2, 0, env=env_sub, **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_fused_env_wrapper_rejects_bad_inputs(cuda):
    fp, compiled, tables, cam, pxy, kw, env = _fused_env_case(cuda, "spherical", 16, 2)
    with pytest.raises(ValueError):  # the persistent mode takes no environment
        fp.paths(tables, cam, pxy, 0, 2, env=env, **kw)
    with pytest.raises(ValueError):  # candidates of another depth
        fp.paths(tables, cam, pxy, 0, 0, env=env, **{**kw, "max_depth": 3})
    with pytest.raises(ValueError):
        fp.paths(tables, cam, pxy, 0, 0, env=env._replace(cand=env.cand.cpu()), **kw)


def _fused_ray_case(cuda, kind, res, depth, sample_index=2):
    """A chip_smoke.py ray_scene and its ray-input lanes (and candidates)
    on a permuted lane list."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid
    from luisarender_tpu_torch.ops import fused_path as fp

    scene = chip_smoke.ray_scene(lt, kind, res=res, depth=depth)
    compiled = lt.compile_scene(scene, device=cuda)
    assert compiled.plan.fused_path
    assert fp.camgen_params(scene.cameras[0], scene.integrator.sampler.seed) is None
    pxy = pixel_grid(res, res, cuda)
    rays, _, env = chip_smoke.ray_inputs(fp, compiled, scene, pxy, sample_index, depth)
    perm = torch.randperm(pxy.shape[0], generator=torch.Generator().manual_seed(res)).to(cuda)
    rays = rays[:, perm].contiguous()
    if env is not None:
        env = env._replace(cand=env.cand[:, :, perm].contiguous())
    kw = dict(max_depth=depth, rr_depth=0, rr_threshold=0.95)
    return fp, compiled, fp.fused_tables(compiled), rays, env, kw


def _rays_equal_to_plain(fp, tables, rays, env, kw):
    out = fp.paths_rays(tables, rays, env=env, **kw)
    torch.cuda.synchronize()
    ref = fp.paths_plain(tables, None, None, 0, 0, env=env, rays=rays, **kw)
    assert len(out) == len(ref) == (2 if env is None else 3)
    for a, b in zip(out, ref):
        assert torch.equal(a, b), ((a != b).float().mean().item(), (a - b).abs().max().item())
    return out


@pytest.mark.parametrize("kind", ["thinlens", "mitchell_clip", "env_thinlens"])
def test_fused_ray_mode_matches_plain(cuda, kind):
    """The ray-input mode (a thin lens with a gaussian filter, a mitchell
    filter's negative weights with a near clip plane, the thin lens under an
    environment): rgb, rays and the escape words bit for bit on every lane
    of a permuted lane list, one launch counted as a ray-input launch."""
    fp, compiled, tables, rays, env, kw = _fused_ray_case(cuda, kind, 128, 6)
    counts = (fp.launches, fp.env_launches, fp.ray_launches, fp.ray_env_launches)
    out = _rays_equal_to_plain(fp, tables, rays, env, kw)
    bump = (0, 0, 1, 0) if env is None else (0, 0, 0, 1)
    assert (fp.launches, fp.env_launches, fp.ray_launches, fp.ray_env_launches) == tuple(
        a + b for a, b in zip(counts, bump))
    rgb = out[0] if env is None else fp.miss_pass(compiled, out[0], out[2], env.p_env)
    assert torch.isfinite(rgb).all() and rgb.mean().item() > 0.0
    if kind == "mitchell_clip":
        assert rays[8].min().item() < 0.0 and rays[6].min().item() > 0.0


@pytest.mark.parametrize("n", [1, 129, 300, 262_144 - 5],
                         ids=["n1", "n129", "under_one_pool", "over_one_wave"])
def test_fused_ray_mode_ragged_counts(cuda, n):
    """Part-filled blocks, warps and slot pools, and more lanes than the
    card holds slots at once: the rays, t ranges and candidates are read and
    the outputs written at the lane's index, never the slot's."""
    kind, res = ("thinlens", 512) if n > 300 else ("env_thinlens", 64)
    fp, compiled, tables, rays, env, kw = _fused_ray_case(cuda, kind, res, 3)
    idx = torch.randperm(rays.shape[1], generator=torch.Generator().manual_seed(n))[:n]
    idx = idx.to(rays.device)
    sub_env = None if env is None else env._replace(cand=env.cand[:, :, idx].contiguous())
    _rays_equal_to_plain(fp, tables, rays[:, idx].contiguous(), sub_env, kw)


def test_fused_ray_mode_back_to_back_launches(cuda):
    """Launches queued without a synchronise between them give the same
    lanes, with and without an environment."""
    for kind in ("mitchell_clip", "env_thinlens"):
        fp, compiled, tables, rays, env, kw = _fused_ray_case(cuda, kind, 256, 4)
        outs = [fp.paths_rays(tables, rays, env=env, **kw) for _ in range(4)]
        torch.cuda.synchronize()
        for o in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


def test_fused_ray_wrapper_rejects_bad_inputs(cuda):
    fp, compiled, tables, rays, env, kw = _fused_ray_case(cuda, "env_thinlens", 16, 2)
    with pytest.raises(ValueError):  # dtype
        fp.paths_rays(tables, rays.double(), env=env, **kw)
    with pytest.raises(ValueError):  # device
        fp.paths_rays(tables, rays.cpu(), env=env, **kw)
    with pytest.raises(ValueError):  # shape
        fp.paths_rays(tables, rays[:9].contiguous(), env=env, **kw)
    with pytest.raises(ValueError):  # not contiguous
        fp.paths_rays(tables, rays[:, ::2], **kw)
    with pytest.raises(ValueError):  # candidates of other lanes
        fp.paths_rays(tables, rays[:, :7].contiguous(), env=env, **kw)
    with pytest.raises(ValueError):  # the persistent mode takes no rays
        fp.paths_plain(tables, None, None, 0, 2, rays=rays.cpu(), **kw)
    # the C function refuses rays with n_samples != 0, and a launch without
    # rays or pixels
    with pytest.raises(RuntimeError, match="CUDA error"):
        fp._launch(tables, None, rays.shape[1], rays.device, None, rays, 0, 2, None, None, kw)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fp._launch(tables, None, rays.shape[1], rays.device, None, None, 0, 0, None, None, kw)
    out = fp.paths_rays(tables, rays[:, :0].contiguous(), **kw)
    assert out[0].shape == (0, 3) and out[1].shape == (0,)


def test_fused_ray_mode_fed_camgen_rays_equals_camgen(cuda):
    """The ray-input mode fed the camgen mode's own camera rays and states
    (the plain version's gen_from_cam) renders the camgen kernel's lanes
    bit for bit: both modes share one path."""
    from luisarender_tpu_torch.core.types import make_ray

    fp, tables, cam, pxy, kw = _fused_case(cuda, "scenes/cornell.json", 256, 6)
    pl = fp._Plain(tables, cam, pxy, kw["max_depth"], 0, 0.95)
    st, o, d = pl.gen_from_cam(torch.full((pxy.shape[0],), 4, dtype=torch.int64, device=cuda))
    ray = make_ray(torch.stack(o, -1), torch.stack(d, -1), 0.0, math.inf)
    rays = fp.pack_rays(ray, torch.ones(pxy.shape[0], device=cuda), st)
    rgb_r, rays_r = fp.paths_rays(tables, rays, **kw)
    rgb_c, rays_c = fp.paths(tables, cam, pxy, 4, 0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(rgb_r, rgb_c) and torch.equal(rays_r, rays_c)


def _bvh8_case(cuda, n_tris, n_rays, seed):
    """The cluster case's rays and tables with the 8-wide tables beside
    them: (o, d, t_min, t_max), (slab8, meta8, cboxes, tris, woop)."""
    from luisarender_tpu_torch.ops import subpacket, wide8

    _, (o, d, t_min, t_max, nodes, tris) = _cluster_case(cuda, n_tris, n_rays, seed)
    nodes_np, tris_np = nodes.cpu().numpy(), tris.cpu().numpy()
    slab8, meta8 = subpacket.build_slab_meta(subpacket.build_bvh8(nodes_np))
    cboxes = wide8.build_cluster_boxes(nodes_np)
    woop = subpacket.build_woop_table(tris_np)
    return (o, d, t_min, t_max), (*_to(cuda, slab8, meta8, cboxes), tris, *_to(cuda, woop))


def _same_walk(launch, args, any_hit, want, cuda):
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = torch.zeros_like(want)
    launch(*args, any_hit, err, got)
    torch.cuda.synchronize()
    assert int(err.item()) == 0
    assert torch.equal(got, want)


def _deep_case(cuda, n_rays):
    """torch_parity.deep_bvh8's tree, whose stack bound (141) takes the
    kernels' larger stack, and rays through it, a fifth with t_max 0.5."""
    from torch_parity import deep_bvh8, soup_rays

    slab8, meta8, cboxes, tris, woop, _, _ = deep_bvh8()
    o, d, t_min, t_max = soup_rays(19, 3e38, n_rays)
    t_max[1::5] = 0.5
    return _to(cuda, o, d, t_min, t_max), _to(cuda, slab8, meta8, cboxes, tris, woop)


@pytest.mark.parametrize("n_tris,n_rays", [(100, 1000), (8000, 100_003), (0, 20_000)],
                         ids=["one_node", "t8000_ragged", "deep_tree"])
def test_bvh8_kernels_match_plain(cuda, n_tris, n_rays):
    from luisarender_tpu_torch.ops import subpacket, wide8

    if n_tris:
        rays, (slab8, meta8, cboxes, tris, woop) = _bvh8_case(cuda, n_tris, n_rays, 13)
    else:
        rays, (slab8, meta8, cboxes, tris, woop) = _deep_case(cuda, n_rays)
        assert subpacket.stack8_need(meta8.cpu().numpy()) > subpacket.STACKS8[0]
    w_args = (*rays, slab8, meta8, cboxes, tris)
    s_args = (*rays, slab8, meta8, woop)
    counts = (wide8.closest_launches, wide8.any_launches, subpacket.closest_launches,
              subpacket.any_launches)
    kern_w = wide8.closest(*w_args)
    occ_w = wide8.any_hit(*w_args)
    kern_s = subpacket.closest(*s_args)
    occ_s = subpacket.any_hit(*s_args)
    torch.cuda.synchronize()
    assert (wide8.closest_launches, wide8.any_launches, subpacket.closest_launches,
            subpacket.any_launches) == tuple(c + 1 for c in counts)
    st = wide8.wide8_plain(*w_args, False)
    _assert_same(kern_w, (torch.where(st.best_s >= 0, st.best_t, math.inf), st.best_s,
                          st.best_u, st.best_v))
    _same_walk(wide8.launch, w_args, False, st.stats, cuda)
    st_any = wide8.wide8_plain(*w_args, True)
    assert torch.equal(occ_w, st_any.occ)
    _same_walk(wide8.launch, w_args, True, st_any.stats, cuda)
    t, slot = subpacket.closest_plain(*s_args)
    assert torch.equal(kern_s[1], slot) and torch.equal(kern_s[0], t)
    assert bool(torch.isnan(kern_s[2]).all() and torch.isnan(kern_s[3]).all())
    _same_walk(subpacket.launch, s_args, False, subpacket.subpacket_plain(*s_args, False).stats,
               cuda)
    st_any = subpacket.subpacket_plain(*s_args, True)
    assert torch.equal(occ_s, st_any.occ)
    _same_walk(subpacket.launch, s_args, True, st_any.stats, cuda)
    assert 0.01 < (kern_w[1] >= 0).float().mean().item() < 0.95
    assert 0.01 < occ_w.float().mean().item() < 0.95


def test_wide8_overlapping_leaves_match_plain(cuda):
    """torch_parity.overlapping_leaves_bvh8 on the card: a pop's later leaf
    dropped by the box re-test against the best t an earlier leaf left;
    every output and the per-ray walk counts equal the plain version's and
    the values the case implies, and the counted build drops the leaves the
    case implies (5 for closest hits, none for any-hit, which stops at its
    first occluder)."""
    from luisarender_tpu_torch.ops import wide8
    from torch_parity import overlapping_leaves_bvh8

    tables, _, rays, want = overlapping_leaves_bvh8()
    args = _to(cuda, *rays, *tables)
    st = wide8.wide8_plain(*args, False)
    kern = wide8.closest(*args)
    _assert_same(kern, (torch.where(st.best_s >= 0, st.best_t, math.inf), st.best_s,
                        st.best_u, st.best_v))
    assert kern[1].cpu().numpy().tolist() == want["slot"].tolist()
    assert torch.equal(st.stats.cpu(), torch.as_tensor(want["stats"]))
    occ = wide8.any_hit(*args)
    assert occ.cpu().numpy().tolist() == want["occ"].tolist()
    for any_hit, key, culled in ((False, "stats", 5), (True, "stats_any", 0)):
        err = torch.zeros(1, dtype=torch.int32, device=cuda)
        stats = torch.zeros((7, 3), dtype=torch.int32, device=cuda)
        ctr = torch.zeros(len(wide8.COUNTERS), dtype=torch.int64, device=cuda)
        wide8.launch(*args, any_hit, err, stats, counters=ctr)
        torch.cuda.synchronize()
        assert int(err.item()) == 0
        assert stats.cpu().numpy().tolist() == want[key].tolist()
        c = dict(zip(wide8.COUNTERS, ctr.tolist()))
        assert c["culled"] == culled and c["parked"] == int(want[key][:, 1].sum())


def test_wide8_counted_build_equals_uncounted(cuda):
    """The counted build (lane counters) gives the uncounted build's outputs
    and walk counts, in caller order and on the rays in the reference's
    coherence order; its counters agree with the walk counts they sum."""
    from luisarender_tpu_torch.ops import subpacket, wide8

    rays, (slab8, meta8, cboxes, tris, _) = _bvh8_case(cuda, 8000, 50_001, 21)
    for order in ("caller", "sorted"):
        if order == "sorted":
            perm = subpacket.coherence_order(*rays, meta8)
            rays = tuple(x.index_select(0, perm) for x in rays)
        args = (*rays, slab8, meta8, cboxes, tris)
        for any_hit in (False, True):
            runs = []
            for counted in (False, True):
                err = torch.zeros(1, dtype=torch.int32, device=cuda)
                stats = torch.zeros((50_001, 3), dtype=torch.int32, device=cuda)
                ctr = (torch.zeros(len(wide8.COUNTERS), dtype=torch.int64, device=cuda)
                       if counted else None)
                out = wide8.launch(*args, any_hit, err, stats, counters=ctr)
                torch.cuda.synchronize()
                assert int(err.item()) == 0
                runs.append(((out,) if any_hit else out, stats, ctr))
            (plain_out, plain_stats, _), (cnt_out, cnt_stats, ctr) = runs
            assert all(torch.equal(a, b) for a, b in zip(plain_out, cnt_out))
            assert torch.equal(plain_stats, cnt_stats)
            c = dict(zip(wide8.COUNTERS, ctr.tolist()))
            assert c["pops"] == int(cnt_stats[:, 0].sum()) <= c["pop_slots"]
            assert c["parked"] == int(cnt_stats[:, 1].sum())
            assert c["rows"] == int(cnt_stats[:, 2].sum()) <= c["row_slots"]
            assert 0 < c["rounds"] <= c["parked"] and 0 < c["loads"] <= c["parked"]
            if not any_hit:
                assert c["culled"] > 0


def test_wide8_stack_builds_agree(cuda):
    """The kernel takes the stack build that ops/wide8.py stack_build names."""
    from luisarender_tpu_torch.ops import wide8

    lib = wide8._library()
    for bound in (0, 1, 34, 48, 49, 64, 141, 2048, 2049):
        assert lib.wide8_stack_build(bound) == wide8.stack_build(bound)


def test_subpacket_woop_ties_match_plain(cuda):
    """torch_parity.woop_ties_bvh8 on the card: rows of one cluster tying in
    t (the least slot wins, not the lowest row), a pop's several leaf
    clusters all tested, a transparent hit in front of an opaque one; every
    output and the per-ray walk counts equal the plain version's and the
    values the case implies, in the uncounted and the counted build, whose
    counters sum the walk counts."""
    from luisarender_tpu_torch.ops import subpacket
    from torch_parity import woop_ties_bvh8

    tables, _, rays, want = woop_ties_bvh8()
    args = _to(cuda, *rays, *tables)
    t, slot, _, _ = subpacket.closest(*args)
    _assert_same((t, slot), subpacket.closest_plain(*args))
    assert slot.cpu().numpy().tolist() == want["slot"].tolist()
    occ = subpacket.any_hit(*args)
    assert torch.equal(occ, subpacket.any_plain(*args))
    assert occ.cpu().numpy().tolist() == want["occ"].tolist()
    for any_hit, key in ((False, "stats"), (True, "stats_any")):
        plain = subpacket.subpacket_plain(*args, any_hit).stats
        assert plain.cpu().numpy().tolist() == want[key].tolist()
        for counted in (False, True):
            err = torch.zeros(1, dtype=torch.int32, device=cuda)
            stats = torch.zeros((7, 3), dtype=torch.int32, device=cuda)
            ctr = (torch.zeros(len(subpacket.COUNTERS), dtype=torch.int64, device=cuda)
                   if counted else None)
            subpacket.launch(*args, any_hit, err, stats, counters=ctr)
            torch.cuda.synchronize()
            assert int(err.item()) == 0
            assert torch.equal(stats, plain)
            if counted:
                c = dict(zip(subpacket.COUNTERS, ctr.tolist()))
                sums = want[key].sum(axis=0)
                assert (c["pops"], c["parked"], c["rows"]) == tuple(int(x) for x in sums)


def test_subpacket_counted_build_equals_uncounted(cuda):
    """The counted build (lane counters) gives the uncounted build's outputs
    and walk counts, in caller order and on the rays in the reference's
    coherence order, and the sorted route (launch_sorted) gives the caller
    order's; the counters agree with the walk counts they sum."""
    from luisarender_tpu_torch.ops import subpacket

    rays, (slab8, meta8, _, _, woop) = _bvh8_case(cuda, 8000, 50_001, 22)
    tables = (slab8, meta8, woop)
    for any_hit in (False, True):
        base = None
        for order in ("caller", "sorted"):
            perm = subpacket.coherence_order(*rays, meta8)
            r = rays if order == "caller" else tuple(x.index_select(0, perm) for x in rays)
            runs = []
            for counted in (False, True):
                err = torch.zeros(1, dtype=torch.int32, device=cuda)
                stats = torch.zeros((50_001, 3), dtype=torch.int32, device=cuda)
                ctr = (torch.zeros(len(subpacket.COUNTERS), dtype=torch.int64, device=cuda)
                       if counted else None)
                out = subpacket.launch(*r, *tables, any_hit, err, stats, counters=ctr)
                torch.cuda.synchronize()
                assert int(err.item()) == 0
                runs.append(((out,) if any_hit else out, stats, ctr))
            (plain_out, plain_stats, _), (cnt_out, cnt_stats, ctr) = runs
            assert all(torch.equal(a, b) for a, b in zip(plain_out, cnt_out))
            assert torch.equal(plain_stats, cnt_stats)
            c = dict(zip(subpacket.COUNTERS, ctr.tolist()))
            assert c["pops"] == int(cnt_stats[:, 0].sum()) <= c["pop_slots"]
            assert c["parked"] == int(cnt_stats[:, 1].sum())
            assert c["rows"] == int(cnt_stats[:, 2].sum()) <= c["row_slots"]
            assert 0 < c["rounds"] <= c["parked"] and 0 < c["loads"] <= c["parked"]
            if order == "caller":
                base = (plain_out, plain_stats)
        err = torch.zeros(1, dtype=torch.int32, device=cuda)
        stats = torch.zeros((50_001, 3), dtype=torch.int32, device=cuda)
        out = subpacket.launch_sorted(*rays, *tables, any_hit, err, stats)
        torch.cuda.synchronize()
        assert int(err.item()) == 0
        assert all(torch.equal(a, b) for a, b in zip((out,) if any_hit else out, base[0]))
        assert torch.equal(stats, base[1])


def test_subpacket_stack_builds_agree(cuda):
    """The kernel takes the stack build that ops/subpacket.py stack_build
    names."""
    from luisarender_tpu_torch.ops import subpacket

    lib = subpacket._library()
    for bound in (0, 1, 34, 48, 49, 64, 141, 2048, 2049):
        assert lib.subpacket_stack_build(bound) == subpacket.stack_build(bound)


def test_bvh8_wrappers_raise_on_bad_inputs_and_trees(cuda):
    from luisarender_tpu_torch.ops import subpacket, wide8
    from torch_parity import malformed_bvh8

    (o, d, t_min, t_max), (slab8, meta8, cboxes, tris, woop) = _bvh8_case(cuda, 700, 256, 14)
    for mod, leaf in ((wide8, (cboxes, tris)), (subpacket, (woop,))):
        with pytest.raises(TypeError):
            mod.closest(o.double(), d, t_min, t_max, slab8, meta8, *leaf)
        with pytest.raises(ValueError):
            mod.any_hit(o, d, t_min, t_max, slab8[:, :6].contiguous(), meta8, *leaf)
        with pytest.raises(ValueError):
            mod.closest(o.cpu(), d, t_min, t_max, slab8, meta8, *leaf)
        out = mod.closest(o[:0], d[:0], t_min[:0], t_max[:0], slab8, meta8, *leaf)
        assert out[1].shape == (0,)
    ray = torch.zeros((4, 3), device=cuda)
    x = torch.tensor([[1.0, 0.0, 0.0]], device=cuda).repeat(4, 1)
    rays = (ray, x, torch.zeros(4, device=cuda), torch.full((4,), math.inf, device=cuda))
    for kind, message in (("steps", "pops"), ("stack", "stack deeper"),
                          ("deep", "stack deeper"), ("index", "out of range")):
        slab8_bad, meta8_bad, stack = malformed_bvh8(kind)
        bad = _to(cuda, slab8_bad, meta8_bad)
        for fn, leaf in ((wide8.closest, (cboxes[:1].contiguous(), tris[:1].contiguous())),
                         (wide8.any_hit, (cboxes[:1].contiguous(), tris[:1].contiguous())),
                         (subpacket.closest, (woop[:1].contiguous(),)),
                         (subpacket.any_hit, (woop[:1].contiguous(),))):
            with pytest.raises(RuntimeError, match=message):
                fn(*rays, *bad, *leaf, stack=stack)


def _trace_case(cuda, n_tris, n_rays, seed):
    from luisarender_tpu_torch.accel.native import build_bvh_sah
    from luisarender_tpu_torch.accel.traverse import TraceGeometry
    from luisarender_tpu_torch.ops import trace
    from torch_parity import soup

    positions, triangles = soup(n_tris, seed)
    bvh = build_bvh_sah(positions, triangles)
    srt = triangles[bvh.prim_index]
    v0, v1, v2 = (positions[srt[:, k]] for k in range(3))
    arrays = {"tri_v0": v0, "tri_e1": v1 - v0, "tri_e2": v2 - v0,
              "prim_index": bvh.prim_index, "aabb_min": bvh.aabb_min,
              "aabb_max": bvh.aabb_max, "skip": bvh.skip, "node_first": bvh.node_first,
              "node_count": bvh.node_count}
    nodes, tris = trace.pack_tables(TraceGeometry(
        num_rows=n_tris, **{k: torch.as_tensor(v, device=cuda) for k, v in arrays.items()}))
    _, (o, d, t_min, t_max, _, _) = _cluster_case(cuda, 100, n_rays, seed)
    return trace, (o, d, t_min, t_max, nodes, tris, bvh.leaf_size)


@pytest.mark.parametrize("n_tris,n_rays", [(100, 1000), (8000, 100_003)],
                         ids=["small", "t8000_ragged"])
def test_trace_kernel_matches_plain(cuda, n_tris, n_rays):
    trace, args = _trace_case(cuda, n_tris, n_rays, 15)
    l0 = trace.launches
    kern = trace.closest(*args)
    torch.cuda.synchronize()
    assert trace.launches == l0 + 1
    t, prim, u, v, stats = trace.walk_plain(*args)
    _assert_same(kern, (t, prim, u, v))
    assert 0.01 < (kern[1] >= 0).float().mean().item() < 0.95
    err = torch.zeros(1, dtype=torch.int32, device=args[0].device)
    got = torch.zeros_like(stats)
    trace.launch(*args, err, got)
    torch.cuda.synchronize()
    assert int(err.item()) == 0 and torch.equal(got, stats)


def test_trace_wrapper_raises_on_bad_inputs_and_trees(cuda):
    from torch_parity import malformed_tree

    trace, (o, d, t_min, t_max, nodes, tris, leaf_size) = _trace_case(cuda, 700, 256, 16)
    with pytest.raises(TypeError):
        trace.closest(o.double(), d, t_min, t_max, nodes, tris, leaf_size)
    with pytest.raises(ValueError):
        trace.closest(o, d, t_min, t_max, nodes[:, :8].contiguous(), tris, leaf_size)
    with pytest.raises(ValueError):
        trace.closest(o.cpu(), d, t_min, t_max, nodes, tris, leaf_size)
    assert trace.closest(o[:0], d[:0], t_min[:0], t_max[:0], nodes, tris,
                         leaf_size)[1].shape == (0,)
    ray = torch.zeros((4, 3), device=cuda)
    x = torch.tensor([[1.0, 0.0, 0.0]], device=cuda).repeat(4, 1)
    rays = (ray, x, torch.zeros(4, device=cuda), torch.full((4,), math.inf, device=cuda))
    for kind, message in (("steps", "pops"), ("stack", "stack deeper"),
                          ("deep", "stack deeper"), ("index", "out of range")):
        nodes_bad, tris_bad, stack = malformed_tree(kind)
        with pytest.raises(RuntimeError, match=message):
            trace.closest(*rays, *_to(cuda, nodes_bad, tris_bad), 4, stack=stack)


@pytest.mark.parametrize("case", ["dup_left_nearer", "dup_right_nearer", "face_plane"])
def test_trace_kernel_ties_take_the_lower_row(cuda, case):
    """An exact t tie across two leaves (tests/torch_parity.py tie_tree and
    face_tie_tree): the kernel keeps the lower row, as walk_plain and the
    reference do, where either leaf's box is entered first and where the
    tie lies in the lower-row leaf's entry face."""
    from luisarender_tpu_torch.accel.traverse import TraceGeometry
    from luisarender_tpu_torch.ops import trace
    from torch_parity import face_tie_tree, tie_tree

    arrays, rays = face_tie_tree() if case == "face_plane" else tie_tree(
        case == "dup_right_nearer")
    nodes, tris = trace.pack_tables(TraceGeometry(
        num_rows=4, **{k: torch.as_tensor(v, device=cuda) for k, v in arrays.items()}))
    args = (*_to(cuda, *rays), nodes, tris, 4)
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    stats = torch.zeros((rays[0].shape[0], 3), dtype=torch.int32, device=cuda)
    kern = trace.launch(*args, err, stats)
    torch.cuda.synchronize()
    t, prim, u, v, walk = trace.walk_plain(*args)
    assert int(err.item()) == 0 and torch.equal(stats, walk)
    _assert_same(kern, (t, prim, u, v))
    if case == "face_plane":
        assert bool((kern[1] == 0).all())
    else:
        assert kern[1][:2].tolist() == [-1, -1] and bool((kern[1][2:] == 1).all())


def test_trace_counted_build_matches_uncounted(cuda):
    """The counted build gives the uncounted one's outputs and walk counts,
    and its lane counters add up to the walk's."""
    trace, args = _trace_case(cuda, 8000, 100_003, 17)
    n = args[0].shape[0]
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    plain_stats = torch.zeros((n, 3), dtype=torch.int32, device=cuda)
    counted_stats = torch.zeros_like(plain_stats)
    ctr = torch.zeros(len(trace.COUNTERS), dtype=torch.int64, device=cuda)
    out = trace.launch(*args, err, plain_stats)
    counted = trace.launch(*args, err, counted_stats, counters=ctr)
    torch.cuda.synchronize()
    assert int(err.item()) == 0
    _assert_same(counted, out)
    assert torch.equal(counted_stats, plain_stats)
    c = dict(zip(trace.COUNTERS, ctr.tolist()))
    pops, leaves, rows = (int(x) for x in plain_stats.sum(0).tolist())
    assert c["pops"] == pops and c["parked"] == leaves and c["rows"] == rows
    assert 0 < c["rounds"] <= leaves and 0 < c["loads"] <= leaves
    assert pops <= c["pop_slots"] and rows <= c["row_slots"]


def test_trace_stack_builds_agree(cuda):
    """The kernel takes the stack build that ops/trace.py stack_build names,
    and its 32-, 64- and 512-entry builds give the same answer and walk."""
    trace, args = _trace_case(cuda, 8000, 100_003, 18)
    lib = trace._library()
    for bound in (1, 23, 32, 33, 64, 65, 512, 513):
        assert lib.trace_stack_build(bound) == trace.stack_build(bound)
    need = trace.tree_stack(args[4])
    assert need <= trace.STACKS[0]
    n = args[0].shape[0]
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    runs = []
    for stack in (need, trace.STACKS[0] + 1, trace.STACKS[1] + 1):
        stats = torch.zeros((n, 3), dtype=torch.int32, device=cuda)
        runs.append((trace.launch(*args, err, stats, stack=stack), stats))
    torch.cuda.synchronize()
    assert int(err.item()) == 0
    for out, stats in runs[1:]:
        _assert_same(out, runs[0][0])
        assert torch.equal(stats, runs[0][1])


@pytest.mark.parametrize("grouped", [False, True], ids=["meshes", "group_instances"])
def test_two_level_composition_matches_plain_walk(cuda, tmp_path, grouped):
    """The two-level route on the card (accel/twolevel.py: a cluster.cu
    launch a visible instance, the rays in its object space, the best t as
    t_max) against the plain TLAS/BLAS walk on the card, on the reference's
    instanced scene (tests/torch_parity.py instanced_scene) and 4,096
    seeded rays plus 256 axis-aligned ones: the same hits, prims and
    instances on every lane, t within 1e-5 relative, the same occlusion;
    one launch a visible instance (any-hit: a visible opaque one) and one
    read of the error word a trace."""
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch.accel import twolevel
    from luisarender_tpu_torch.core.types import Ray
    from luisarender_tpu_torch.ops import cluster
    from torch_parity import instanced_rays, instanced_scene

    comp = lt.compile_scene(lt.Scene.from_dict(instanced_scene(tmp_path, "twolevel", grouped)),
                            device=cuda)
    geom = comp.trace_geometry()
    rays = Ray(*_to(cuda, *instanced_rays(n=4096)))
    n_closest = sum(geom.inst_visible)
    n_any = sum(v and o for v, o in zip(geom.inst_visible, geom.inst_opaque))
    c0, a0 = cluster.closest_launches, cluster.any_launches
    hit = twolevel.trace_closest_2l_cluster(geom, rays)
    occ = twolevel.trace_any_2l_cluster(geom, rays)
    assert cluster.closest_launches - c0 == n_closest and cluster.any_launches - a0 == n_any
    ref = twolevel.trace_closest_2l(geom, rays)
    found = ref.prim >= 0
    assert 0.05 < float(found.float().mean()) < 0.9
    assert torch.equal(hit.prim, ref.prim) and torch.equal(hit.inst, ref.inst)
    torch.testing.assert_close(hit.t[found], ref.t[found], rtol=1e-5, atol=0)
    assert torch.isinf(hit.t[~found]).all()
    assert torch.equal(occ, twolevel.trace_any_2l(geom, rays))
    # a mesh tree whose walk never ends: the shared word, then a raise
    box = [-1e3, -1e3, -1e3, 1e3, 1e3, 1e3]
    loop = torch.tensor([box + [0.0, -1.0], box + [-1.0, 0.0]], device=cuda)
    bad = geom._replace(cluster_sets=tuple((loop, t) for _, t in geom.cluster_sets))
    for trace in (twolevel.trace_closest_2l_cluster, twolevel.trace_any_2l_cluster):
        with pytest.raises(RuntimeError, match="malformed cluster tree"):
            trace(bad, rays)


def _coated_inputs(cuda):
    """The brute kernels' inputs of the first sample of testing.cornell_coated
    (mix, layered and normal-mapped surfaces; 32 rows and a glass sphere) at
    256^2 on the general fork: each bounce's closest and shadow rays, the
    trace module's calls recorded."""
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.integrators.mega_path import general_path_trace_batch, pixel_grid

    scene = lt.Scene.from_dict(testing.cornell_coated(resolution=(256, 256), spp=1, depth=4))
    compiled = lt.compile_scene(scene, device=cuda)
    assert not compiled.plan.fused_path and compiled.plan.any_normal_maps
    captured = {"closest": [], "any": []}
    orig = brute.closest, brute.any_hit

    def rec(kind, fn):
        def call(*args):
            captured[kind].append(tuple(a.clone() for a in args))
            return fn(*args)
        return call

    brute.closest, brute.any_hit = rec("closest", orig[0]), rec("any", orig[1])
    try:
        integ = scene.integrator
        general_path_trace_batch(compiled, scene.cameras[0], integ.sampler, integ.light_sampler,
                                 pixel_grid(256, 256, cuda), 0, max_depth=4,
                                 rr_depth=integ.rr_depth, rr_threshold=integ.rr_threshold)
    finally:
        brute.closest, brute.any_hit = orig
    assert captured["closest"] and captured["any"]
    return captured


def test_coated_cornell_inputs_match_plain(cuda):
    """The brute kernels on every input of the coated Cornell box's first
    sample, bit for bit against their plain versions."""
    cap = _coated_inputs(cuda)
    for args in cap["closest"]:
        _assert_same(brute.closest(*args), brute.closest_plain(*args))
    for args in cap["any"]:
        assert torch.equal(brute.any_hit(*args), brute.any_plain(*args))


def test_fused_kernel_on_a_motion_blur_bucket(cuda):
    """The fused kernel on one shutter bucket of testing.cornell_motion (the
    short block moved to its place at t = 0.4, the camera posed at that
    time), every lane bit-equal with the plain version."""
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid
    from luisarender_tpu_torch.ops import fused_path

    scene = lt.Scene.from_dict(testing.cornell_motion(resolution=(128, 128), spp=1))
    t = float(scene.cameras[0].shutter_weights(6)[0][2])
    compiled = lt.compile_scene(scene, device=cuda, time=t)
    assert compiled.plan.fused_path
    cam = fused_path.camgen_params(scene.cameras[0], scene.integrator.sampler.seed, time=t)
    kw = dict(max_depth=8, rr_depth=0, rr_threshold=0.95)
    rgb, _ = _equal_to_plain(fused_path, fused_path.fused_tables(compiled), cam,
                             pixel_grid(128, 128, cuda), 1, 0, kw)
    assert torch.isfinite(rgb).all() and rgb.mean().item() > 0.0


def test_low_discrepancy_draws_on_the_card_equal_the_cpu(cuda, monkeypatch):
    """The five low-discrepancy samplers' states and draws (samplers/lds.py:
    start, then pixel, 1D and 2D draws over 12 dimensions) on cuda:0
    bit-equal with the same draws on the CPU, over 4,096 pixels x 3
    sample indices. sobol reads the 64-dimension prefix of its table,
    repeated, rather than search 1,024 dimensions here."""
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.core import sobolgen

    table = np.resize(sobolgen.sobol_matrices(64, cache=False), (1024, 32))
    monkeypatch.setattr(sobolgen, "sobol_matrices", lambda n_dims=1024, **kw: table[:n_dims])
    pxy = torch.as_tensor(np.random.RandomState(3).randint(0, 1000, (4096, 2)).astype(np.int32))
    for impl in ("paddedsobol", "sobol", "zsobol", "pmj02bn", "tileshared"):
        sampler = lt.Scene.from_dict(testing.with_sampler(
            testing.cornell_box(resolution=(8, 8), spp=1), impl)).integrator.sampler
        for si in (0, 3, 700):
            states = [sampler.start(pxy, si), sampler.start(pxy.to(cuda), si)]
            for op in ("pixel_2d", "1d", "2d", "2d", "1d", "2d", "1d", "1d"):
                outs = [getattr(sampler, "generate_" + op)(s) for s in states]
                states = [o[0] for o in outs]
                assert outs[1][1].device.type == "cuda"
                assert torch.equal(outs[1][1].cpu(), outs[0][1]), (impl, si, op)
            for k in states[0]:
                assert torch.equal(states[1][k].cpu(), states[0][k]), (impl, si, k)


def _fog_inputs(cuda, res=128, iterations=3):
    """The cluster kernels' inputs of the first `iterations` loop iterations
    of the first megavpt sample of scenes/fog.json at res^2 (5,152
    triangles, 5,120 of them the fog sphere's, which block no shadow ray):
    each iteration's closest rays, then its scatter events' shadow rays
    (their origins inside the sphere) and its surface NEE's, the trace
    module's calls recorded in order."""
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.integrators import mega_vpt
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid
    from luisarender_tpu_torch.ops import cluster

    scene = lt.Scene.from_dict(testing.fog((res, res), 1, 10))
    compiled = lt.compile_scene(scene, device=cuda)
    assert compiled.plan.has_media and "cluster_nodes" in compiled.arrays["trace"]
    captured = {"closest": [], "any": []}
    orig = cluster.closest, cluster.any_hit

    def rec(kind, fn):
        def call(*args):
            if len(captured["closest"]) <= iterations:
                captured[kind].append(tuple(a.clone() for a in args))
            return fn(*args)
        return call

    cluster.closest, cluster.any_hit = rec("closest", orig[0]), rec("any", orig[1])
    try:
        integ = scene.integrator
        mega_vpt.vpt_trace_batch(compiled, scene.cameras[0], integ.sampler, integ.light_sampler,
                                 pixel_grid(res, res, cuda), 0, max_depth=10,
                                 rr_depth=integ.rr_depth, rr_threshold=integ.rr_threshold)
    finally:
        cluster.closest, cluster.any_hit = orig
    return captured


def test_fog_cluster_inputs_match_plain(cuda):
    """The cluster kernels on the fog scene's rays bit for bit against their
    plain versions, the scatter events' shadow rays (their origins inside
    the sphere, past its non-opaque triangles) among them."""
    from luisarender_tpu_torch.ops import cluster

    cap = _fog_inputs(cuda)
    assert len(cap["closest"]) >= 3 and len(cap["any"]) >= 6
    for args in cap["closest"]:
        _assert_same(cluster.closest(*args), cluster.closest_plain(*args))
    live_inside = 0
    for args in cap["any"]:
        assert torch.equal(cluster.any_hit(*args), cluster.any_plain(*args))
        o, t_max = args[0], args[3]
        c = torch.tensor([275.0, 180.0, 280.0], device=cuda)
        live_inside += int(((t_max > 0) & ((o - c).norm(dim=-1) < 118.0)).sum())
    assert live_inside > 100


@pytest.mark.parametrize("name", ["fog", "fog_grid"])
def test_megavpt_render_on_the_card_matches_golden(cuda, name):
    """scenes/fog.json and testing.fog_grid at 32^2, 8 spp, depth 10 on the
    card against the reference's CPU renders tests/golden/<name>_32_8spp.exr:
    under 2% of pixels off by more than 1e-3, the mean within 0.5%."""
    from pathlib import Path

    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.ops import cluster
    from luisarender_tpu_torch.utils import imageio

    d = testing.fog((32, 32), 8, 10) if name == "fog" else testing.fog_grid((32, 32), 8, 10)
    scene = lt.Scene.from_dict(d)
    c0, a0 = cluster.closest_launches, cluster.any_launches
    img = lt.render(scene, device=cuda)["fog.exr"]
    iterations = scene.integrator.iterations_run
    assert cluster.closest_launches - c0 == iterations > 0
    assert cluster.any_launches - a0 == 2 * iterations
    golden = Path(__file__).resolve().parent / "golden" / f"{name}_32_8spp.exr"
    ref = imageio.load_exr(str(golden))
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert float((np.abs(img - ref).max(-1) > 1e-3).mean()) < 0.02
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005


def _soup_tables(dev, seed=5, n_tris=3000):
    """A random soup's tables for the four trace modules, on `dev`."""
    from luisarender_tpu_torch.ops import subpacket, wide8
    from torch_parity import cluster_case

    pos, tris, opaque, order, _, nodes, ctris = cluster_case(n_tris, seed)
    slab8, meta8 = subpacket.build_slab_meta(subpacket.build_bvh8(nodes))
    bt, _ = _random_table(400, seed)
    return {
        "brute": _to(dev, bt),
        "cluster": _to(dev, nodes, ctris),
        "wide8": _to(dev, slab8, meta8, wide8.build_cluster_boxes(nodes), ctris),
        "subpacket": _to(dev, slab8, meta8, subpacket.build_woop_table(ctris)),
    }


@pytest.mark.parametrize("kind", ["closest", "any_hit"])
@pytest.mark.parametrize("name", ["brute", "cluster", "wide8", "subpacket"])
def test_trace_wrappers_pass_no_gradient_on_the_card(cuda, name, kind):
    """Each CUDA trace wrapper is a torch.autograd.Function
    (ops/nograd.py): under autograd its launch gives the outputs of the
    launch under no_grad bit for bit, and backward through t passes no
    gradient to the rays."""
    from luisarender_tpu_torch.ops import cluster, subpacket, wide8
    from torch_parity import soup_rays

    mod = {"brute": brute, "cluster": cluster, "wide8": wide8, "subpacket": subpacket}[name]
    entry = getattr(mod, kind)
    tables = _soup_tables(cuda)[name]
    if name == "brute":
        o, d, t_min, t_max = _to(cuda, *_random_rays(20_000, _random_table(400, 5)[1], 9))
    else:
        o, d, t_min, t_max = _to(cuda, *soup_rays(6, 3.0, n_rays=20_003))
    with torch.no_grad():
        ref = entry(o, d, t_min, t_max, *tables)
    og = o.clone().requires_grad_(True)
    out = entry(og, d, t_min, t_max, *tables)
    outs, refs = (out, ref) if kind == "closest" else ((out,), (ref,))
    for x, y in zip(outs, refs):
        assert torch.equal(x.detach(), y) or (torch.isnan(y).all() and torch.isnan(x).all())
    if kind == "any_hit":
        assert not out.requires_grad and 0 < int(out.sum()) < out.shape[0]
        return
    t = out[0]
    assert t.requires_grad and not out[1].requires_grad
    (torch.where(torch.isfinite(t), t, 0.0).sum() + (og * 0.0).sum()).backward()
    assert float(og.grad.abs().max()) == 0.0


def _diff_cornell(dev):
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch import testing

    scene = lt.Scene.from_dict(testing.cornell_box(resolution=(16, 16), spp=4, depth=3))
    return scene, lt.compile_scene(scene, device=dev)


def test_diff_gradient_on_the_card_matches_the_cpu(cuda):
    """d mean(img) / d the constant-texture table at 16^2, 2 spp, depth 3,
    on the card (brute kernels) and on the CPU (their plain versions): each
    entry within 1% relative or 1e-5 absolute, the CPU test's rule
    (tests/test_torch_diff.py)."""
    from luisarender_tpu_torch.diff.render import get_in, make_render_fn

    path = ("textures", "constant", "value")
    grads = []
    for dev in (cuda, torch.device("cpu")):
        scene, compiled = _diff_cornell(dev)
        render = make_render_fn(compiled, scene.cameras[0], scene.integrator, spp=2,
                                max_depth=3)
        v = get_in(compiled.arrays, path).clone().requires_grad_(True)
        render({path: v}, compiled.arrays).mean().backward()
        grads.append(v.grad.cpu().numpy())
    gap = np.abs(grads[0] - grads[1])
    assert np.all((gap <= 0.01 * np.abs(grads[1])) | (gap <= 1e-5)), float(gap.max())
    assert np.abs(grads[1]).max() > 1e-4


def test_recover_albedo_on_the_card(cuda):
    """tests/test_diff.py::test_recover_albedo on the port, on the card: 48
    Adam steps from grey walls recover the table's red, green and white
    walls and the emission by that test's criteria."""
    from luisarender_tpu_torch.diff.optimize import recover
    from luisarender_tpu_torch.diff.render import get_in, make_render_fn

    path = ("textures", "constant", "value")
    scene, compiled = _diff_cornell(cuda)
    cam, integ = scene.cameras[0], scene.integrator
    true = get_in(compiled.arrays, path)
    with torch.no_grad():
        target = make_render_fn(compiled, cam, integ, spp=4, max_depth=3)({path: true},
                                                                          compiled.arrays)
    init = true.cpu().numpy().copy()
    true = true.cpu().numpy()
    emis_row = int(np.argmax(init[:, :3].max(axis=1)))
    for i in range(init.shape[0]):
        if i != emis_row:
            init[i, :3] = 0.5
    params, losses = recover(compiled, cam, integ, target, {path: init}, spp=4, max_depth=3,
                             steps=48, learning_rate=8e-2, param_bounds=(0.0, 32.0))
    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])
    rec = params[path].cpu().numpy()
    np.testing.assert_allclose(rec[0, :3], true[0, :3], atol=0.05)
    np.testing.assert_allclose(rec[emis_row, :3], true[emis_row, :3], rtol=0.05)
    red_row, green_row = 4, 3
    assert np.argmax(rec[red_row, :3]) == 0 and np.argmax(rec[green_row, :3]) == 1
    np.testing.assert_allclose(rec[red_row, 0], true[red_row, 0], atol=0.1)
    np.testing.assert_allclose(rec[green_row, 1], true[green_row, 1], atol=0.1)


def test_cli_renders_on_the_card(cuda, tmp_path, capsys):
    """The command line (cli.main, no device: the card) on a 64^2 Cornell
    file, 8 spp: its EXR equal to render_file's of the same file bit for
    bit, one fused launch a sample and no other kernel launch."""
    import json

    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch import cli, testing
    from luisarender_tpu_torch.ops import cluster, fused_path
    from luisarender_tpu_torch.utils import imageio

    path = tmp_path / "cornell.json"
    path.write_text(json.dumps(testing.cornell_box(resolution=(64, 64), spp=8, depth=5)))
    out = tmp_path / "cli.exr"
    before = (fused_path.launches, fused_path.env_launches, fused_path.persistent_launches,
              fused_path.ray_launches, fused_path.ray_env_launches, brute.closest_launches,
              brute.any_launches, cluster.closest_launches, cluster.any_launches)
    assert cli.main([str(path), "-o", str(out)]) == 0
    after = (fused_path.launches, fused_path.env_launches, fused_path.persistent_launches,
             fused_path.ray_launches, fused_path.ray_env_launches, brute.closest_launches,
             brute.any_launches, cluster.closest_launches, cluster.any_launches)
    assert [a - b for a, b in zip(after, before)] == [8, 0, 0, 0, 0, 0, 0, 0, 0]
    assert capsys.readouterr().out.split() == [str(out)]
    ref = lt.render_file(str(path), save=False, device=cuda)["cornell.exr"]
    img = imageio.load_exr(out)
    assert img.shape == (64, 64, 3) and np.isfinite(img).all() and img.mean() > 0.0
    np.testing.assert_array_equal(img, ref)
