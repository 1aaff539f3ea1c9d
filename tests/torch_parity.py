"""Helpers of the port's parity tests (tests/test_torch_*.py): the
reference's native SAH builder, and the inputs those tests share (random
triangle soups, their cluster tables, rays, and the reference's brute-force
trace geometry over the same SAH-ordered rows).

Importing it also leaves torch one intra-op thread: the suite runs under
pytest-xdist with a worker for nearly every core, and torch's threads on
the port's small CPU tensors only contend there (a render test file that
takes 54 s alone took 690 s under six workers with torch's default eight
threads each; with one thread it takes 42 s alone)."""

import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def require_reference_builder():
    """Make sure luisarender_tpu's native SAH builder is loaded, so that its
    compiler sorts triangles by the same binned-SAH tree as the port's and
    never by its numpy Morton fallback. A process whose first load failed
    (a library another process was still writing, for one) gets its flags
    reset and loads again; fails the test if the builder stays unavailable."""
    from luisarender_tpu.accel import native

    for attempt in range(5):
        if native._LIB is not None:
            return native
        native._LIB = None
        native._LIB_FAILED = False
        native._load()
        if native._LIB is None:
            time.sleep(1.0 + attempt)
    pytest.fail("the reference's native SAH builder (luisarender_tpu/accel/native.py) "
                "could not be loaded; the parity tests never compare against its "
                "Morton fallback")


def soup(n_tris, seed=1):
    """Random small triangles in the unit cube (tests/test_cluster_trace.py
    `_soup`): positions (3T, 3) float32, triangles (T, 3) int32."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (n_tris, 3)).astype(np.float32)
    a = (c + rng.normal(0, 0.05, (n_tris, 3))).astype(np.float32)
    b = (c + rng.normal(0, 0.05, (n_tris, 3))).astype(np.float32)
    d = (c + rng.normal(0, 0.05, (n_tris, 3))).astype(np.float32)
    positions = np.concatenate([a, b, d], 0).astype(np.float32)
    idx = np.arange(n_tris)
    triangles = np.stack([idx, idx + n_tris, idx + 2 * n_tris], 1).astype(np.int32)
    return positions, triangles


def cluster_case(n_tris, seed):
    """Soup, per-original-triangle opacity, its SAH order (leaf size 4, as
    the compiler sorts), each original triangle's slot in it and the port's
    cluster tables (nodes, blocks)."""
    from luisarender_tpu_torch.accel.native import build_bvh_sah
    from luisarender_tpu_torch.ops import cluster

    positions, triangles = soup(n_tris, seed)
    opaque = np.random.default_rng(seed + 6).uniform(size=n_tris) > 0.3
    order = build_bvh_sah(positions, triangles).prim_index
    canon = np.empty(n_tris, np.int64)
    canon[order] = np.arange(n_tris)
    nodes, tris = cluster.build_cluster_tables(positions, triangles, opaque, canon)
    return positions, triangles, opaque, order, canon, nodes, tris


def brute_geom(positions, triangles, opaque, order):
    """The reference's TraceGeometry for its brute-force traces over the
    rows in SAH order, so that its hit slots are the port's."""
    import jax.numpy as jnp
    from luisarender_tpu.accel.traverse import TraceGeometry

    v0, v1, v2 = (positions[triangles[order, k]] for k in range(3))
    t = order.shape[0]
    zero = jnp.zeros(1, jnp.int32)
    return TraceGeometry(
        tri_v0=jnp.asarray(v0), tri_e1=jnp.asarray(v1 - v0), tri_e2=jnp.asarray(v2 - v0),
        prim_index=jnp.arange(t, dtype=jnp.int32), tri_opaque=jnp.asarray(opaque[order]),
        aabb_min=jnp.zeros((1, 3)), aabb_max=jnp.zeros((1, 3)), skip=zero,
        node_first=zero, node_count=zero, leaf_size=4, num_tris=t,
    )


def soup_rays(seed, t_max, n_rays=1500):
    """Rays through the soup's cube (o, d, t_min, t_max) as float32 numpy,
    every 17th lane dead (t_max = 0), as the integrators mark them."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 1.5, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n_rays, 1e-4, np.float32)
    t_max = np.full(n_rays, t_max, np.float32)
    t_max[::17] = 0.0
    return o, d, t_min, t_max


def reference_ray(o, d, t_min, t_max):
    import jax.numpy as jnp
    from luisarender_tpu.core.types import Ray

    return Ray(*(jnp.asarray(x) for x in (o, d, t_min, t_max)))


def to_torch(*arrays):
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]


def count_calls(monkeypatch, *modules):
    """Count the calls of each module's `closest` and `any_hit` trace
    wrappers: {(module name, function): calls}. On the CPU the wrappers run
    their plain versions and count no launch, so a test reads the route
    from these."""
    calls = {}
    for mod in modules:
        name = mod.__name__.rsplit(".", 1)[-1]
        for fn in ("closest", "any_hit"):
            calls[(name, fn)] = 0

            def counted(*a, _orig=getattr(mod, fn), _key=(name, fn)):
                calls[_key] += 1
                return _orig(*a)
            monkeypatch.setattr(mod, fn, counted)
    return calls


def malformed_bvh8(kind):
    """8-wide tables (slab8, meta8; ops/subpacket.py) and the stack bound to
    pass (None: computed from the tree) of a tree that loops (node 1's one
    child is node 1), one whose walk outgrows the bound it is given (24
    nodes, all 8 children of node k are node k + 1, a bound of 16 entries
    where the walk needs 7 D + 1 at depth D), one whose own bound is past
    the kernels' largest stack (the same shape, 300 nodes: 2,094 entries),
    and one whose child index is past its end; every box holds the rays."""
    n8 = {"stack": 24, "deep": 300}.get(kind, 2)
    slab8 = np.zeros((n8, 8, 128), np.float32)
    meta8 = np.zeros((n8, 16), np.float32)
    for a in range(3):
        slab8[:, a, 16 * a:16 * a + 8] = -10.0  # low planes
        slab8[:, a, 16 * a + 8:16 * a + 16] = 10.0  # high planes
        slab8[:, 3 + a, 16 * a:16 * a + 16] = 1.0
    if kind in ("stack", "deep"):
        meta8[:-1, 0:8] = np.arange(1, n8, dtype=np.float32)[:, None]
        meta8[-1, 0] = -1.0  # the last node: one leaf child, cluster 0
        meta8[-1, 8] = 4.0
    else:
        meta8[0, 0] = 1.0
        meta8[1, 0] = 1.0 if kind == "steps" else 5.0
    return slab8, meta8, (16 if kind == "stack" else None)


def deep_bvh8(levels=20, seed=3):
    """A deep, bushy 8-wide tree over one triangle a cluster, built with
    ops/subpacket.py build_slab_meta / build_woop_table: a spine of `levels`
    nodes, each with the next as a child and 7 twigs beside it (the last
    with 8), each twig one leaf cluster. Interior boxes hold the whole
    scene, so a ray that enters pushes every interior child and the walk
    needs its whole bound, 7 levels + 1 = 141 entries at 20 levels, past
    the 8-wide kernels' smaller stack (48). Returns (slab8, meta8, cboxes (C, 8),
    triangle blocks (C, 16, 128), woop, positions (3C, 3), triangles (C,
    3)): cluster c holds triangle c, whose slot is c."""
    from luisarender_tpu_torch.ops import cluster, subpacket

    rng = np.random.default_rng(seed)
    n_twigs = 7 * (levels - 1) + 8
    c = rng.uniform(0, 1, (n_twigs, 1, 3)).astype(np.float32)
    v = (c + rng.normal(0, 0.1, (n_twigs, 3, 3))).astype(np.float32)
    lo, hi = v.min(1), v.max(1)
    table8 = np.zeros((levels + n_twigs, 64), np.float32)
    table8[:, 0::8], table8[:, 3::8] = cluster._BIG, -cluster._BIG  # empty slots

    def child(node, slot, box_lo, box_hi, code):
        table8[node, 8 * slot:8 * slot + 3] = box_lo
        table8[node, 8 * slot + 3:8 * slot + 6] = box_hi
        table8[node, 8 * slot + 6] = code

    twig = 0
    for s in range(levels):
        k = 0
        if s + 1 < levels:
            child(s, 0, -1.0, 2.0, s + 1)
            k = 1
        for slot in range(k, 8):
            child(s, slot, -1.0, 2.0, levels + twig)
            child(levels + twig, 0, lo[twig], hi[twig], -twig - 1.0)
            twig += 1
    slab8, meta8 = subpacket.build_slab_meta(table8)
    tris = np.zeros((n_twigs, cluster.TRI_COLS, cluster.CLUSTER), np.float32)
    tris[:, 0:3, 0] = v[:, 0]
    tris[:, 3:6, 0] = v[:, 1] - v[:, 0]
    tris[:, 6:9, 0] = v[:, 2] - v[:, 0]
    tris[:, 9:11, 0] = 1.0  # valid, opaque
    tris[:, 11, 0] = np.arange(n_twigs)
    cboxes = np.zeros((n_twigs, 8), np.float32)
    cboxes[:, 0:3], cboxes[:, 3:6] = lo, hi
    positions = v.transpose(1, 0, 2).reshape(-1, 3)
    idx = np.arange(n_twigs)
    triangles = np.stack([idx, idx + n_twigs, idx + 2 * n_twigs], 1).astype(np.int32)
    return (slab8, meta8, cboxes, tris, subpacket.build_woop_table(tris), positions,
            triangles)


def malformed_tree(kind):
    """ops/trace.py node and triangle tables and the stack bound to pass
    (None: computed from the tree) of a tree that loops (node 1's right
    sibling is the root), one whose walk outgrows the bound it is given (a
    chain of 70 nodes, each pushing its left child twice, and a bound of
    16), one whose own bound is past the kernel's largest stack (the same
    chain, 600 nodes), and one whose right child lies past its end; every
    box holds the rays, one triangle row."""
    n = {"stack": 70, "deep": 600}.get(kind, 2)
    nodes = np.zeros((n, 16), np.float32)
    nodes[:, 0:3], nodes[:, 3:6] = -10.0, 10.0
    nodes[:, 6] = np.arange(n)  # skip of node k + 1 = k + 1: left = right
    nodes[-1, 7] = 1.0  # the last node is a leaf of row 0
    if kind == "steps":
        nodes[1, 6] = 0.0
    elif kind == "index":
        nodes[1, 6] = 5.0
    return nodes, np.zeros((1, 16), np.float32), (16 if kind == "stack" else None)


def tie_tree(dup_met_first):
    """A hand-built binary tree (the TraceGeometry arrays of ops/trace.py
    pack_tables, leaf size 4) whose two leaves hold the same triangle T
    (rows 1 and 2), so that a ray through T ties exactly in t across the
    leaves, and rays along +x through T. Root (node 0), left leaf (node 1:
    rows 0, 1), right leaf (node 2: rows 2, 3); T lies in the plane x = 5,
    beside it in each leaf an off-path triangle in front of it, at x = 4.5
    in one leaf and x = 4.8 in the other, so that each leaf's box is
    entered before T along +x, the first at 4.5. With `dup_met_first` the
    right leaf holds the one at 4.5, so that a walk entering the nearer box
    first would meet row 2 before row 1; else the left one does. Returns (arrays, rays (o, d,
    t_min, t_max) float32 numpy): 62 rays from x = 0 along +x through T
    (half of them tilted), a dead one and one that misses every box. The
    reference keeps row 1 (met first in preorder) on every ray through T."""
    def tri(x, y, z, size):
        return np.float32([x, y, z]), np.float32([0, size, 0]), np.float32([0, 0, size])

    first, second, dup = tri(4.5, 5, 5, 2), tri(4.8, 5, 5, 2), tri(5, -1, -1, 3)
    rows = [second, dup, dup, first] if dup_met_first else [first, dup, dup, second]
    v0, e1, e2 = (np.stack([r[k] for r in rows]) for k in range(3))
    lo = np.minimum(v0, np.minimum(v0 + e1, v0 + e2))
    hi = np.maximum(v0, np.maximum(v0 + e1, v0 + e2))
    leaf_lo, leaf_hi = np.stack([lo[0:2].min(0), lo[2:4].min(0)]), np.stack([hi[0:2].max(0),
                                                                            hi[2:4].max(0)])
    arrays = {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
              "prim_index": np.arange(4, dtype=np.int32),
              "aabb_min": np.concatenate([leaf_lo.min(0, keepdims=True), leaf_lo]),
              "aabb_max": np.concatenate([leaf_hi.max(0, keepdims=True), leaf_hi]),
              "skip": np.int32([-1, 2, -1]), "node_first": np.int32([-1, 0, 2]),
              "node_count": np.int32([0, 2, 2])}
    rng = np.random.default_rng(9)
    n = 64
    o = np.zeros((n, 3), np.float32)
    o[:, 1:] = rng.uniform(-0.6, 0.2, (n, 2))
    d = np.tile(np.float32([[1.0, 0.0, 0.0]]), (n, 1))
    d[n // 2:, 1:] = rng.uniform(-0.02, 0.02, (n - n // 2, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, np.inf, np.float32)
    t_max[0] = 0.0  # dead
    o[1] = (0.0, 30.0, 30.0)  # misses every box
    return arrays, (o, d.astype(np.float32), t_min, t_max)


def face_tie_tree():
    """A hand-built binary tree as tie_tree's, whose two leaves hold the same
    triangle T (rows 0 and 2, in the plane x = 5): the left leaf's other
    row lies behind T (x = 5.5), so that its box's entry face is T's plane,
    and the right leaf's other row in front of it (x = 4.5), so that its box
    is entered first along +x. Returns (arrays, rays (o, d, t_min, t_max)
    float32 numpy): 64 rays along +x, tilted a little, through T. The
    reference keeps row 0 (met first in preorder) on every ray; a walk that
    entered the nearer box first would meet row 2 first, and on some of
    these rays the left box's slab entry rounds a step above T's
    Moller-Trumbore t, so that such a walk culls it and keeps row 2."""
    def tri(x, y, z, size):
        return np.float32([x, y, z]), np.float32([0, size, 0]), np.float32([0, 0, size])

    dup = tri(5, -1, -1, 3)
    rows = [dup, tri(5.5, 5, 5, 2), dup, tri(4.5, 5, 5, 2)]
    v0, e1, e2 = (np.stack([r[k] for r in rows]) for k in range(3))
    lo = np.minimum(v0, np.minimum(v0 + e1, v0 + e2))
    hi = np.maximum(v0, np.maximum(v0 + e1, v0 + e2))
    leaf_lo, leaf_hi = np.stack([lo[0:2].min(0), lo[2:4].min(0)]), np.stack([hi[0:2].max(0),
                                                                            hi[2:4].max(0)])
    arrays = {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
              "prim_index": np.arange(4, dtype=np.int32),
              "aabb_min": np.concatenate([leaf_lo.min(0, keepdims=True), leaf_lo]),
              "aabb_max": np.concatenate([leaf_hi.max(0, keepdims=True), leaf_hi]),
              "skip": np.int32([-1, 2, -1]), "node_first": np.int32([-1, 0, 2]),
              "node_count": np.int32([0, 2, 2])}
    rng = np.random.default_rng(0)
    n = 64
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng.uniform(-2, 1, n)
    o[:, 1:] = rng.uniform(-0.6, 0.2, (n, 2))
    d = np.tile(np.float32([[1.0, 0.0, 0.0]]), (n, 1))
    d[:, 1:] = rng.uniform(-0.05, 0.05, (n, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return arrays, (o, d.astype(np.float32), np.full(n, 1e-4, np.float32),
                    np.full(n, np.inf, np.float32))


def overlapping_leaves_bvh8():
    """A hand-built 8-wide tree whose root pop hits several leaf clusters
    whose boxes overlap along the x axis, so that a hit in one leaf lets
    the box re-test against the updated best t drop a later one. Root
    (axis x): slot 0 cluster 0 (box x 1-3), slot 1 cluster 1 (x 2.5-6),
    slot 2 interior node 1 (x 0-9), slot 3 cluster 2 (x 5-7); node 1: one
    leaf, cluster 3 (x 7.5-8.5). Cluster c holds one triangle, slot c, in
    the plane x = 2, 4, 6.5, 8: triangles 0-2 cover y + z <= 2, 4, 4 (y, z
    >= -1), triangle 3 covers y, z >= 3, y + z <= 10. Rays along +x from
    x = 0 through (y, z) = P (0, 0), Q (1.5, 1.5), S (4, 4), along -x from
    x = 10 through P, Q with t_max 3, one that misses the root's children
    and a dead one. Returns the tables (slab8, meta8, cboxes, tris), the
    triangles (positions (12, 3), triangles (4, 3)), the rays (o, d, t_min,
    t_max) and what the walk must give: closest (slot, t) and its per-ray
    (pops, leaves, rows), any-hit occlusion and its counts."""
    from luisarender_tpu_torch.ops import cluster, subpacket

    big = cluster._BIG
    table8 = np.zeros((2, 64), np.float32)
    table8[:, 0::8], table8[:, 3::8] = big, -big  # empty slots

    def child(node, slot, lo, hi, code):
        table8[node, 8 * slot:8 * slot + 3] = lo
        table8[node, 8 * slot + 3:8 * slot + 6] = hi
        table8[node, 8 * slot + 6] = code

    boxes = np.float32([[1, -1, -1, 3, 5, 5], [2.5, -1, -1, 6, 5, 5], [5, -1, -1, 7, 5, 5],
                        [7.5, -1, -1, 8.5, 8, 8]])
    for slot, c in ((0, 0), (1, 1), (3, 2)):
        child(0, slot, boxes[c, :3], boxes[c, 3:], -c - 1.0)
    child(0, 2, (0, -1, -1), (9, 8, 8), 1.0)
    child(1, 0, boxes[3, :3], boxes[3, 3:], -4.0)
    table8[:, 7] = 0.0  # sort axis x
    slab8, meta8 = subpacket.build_slab_meta(table8)
    v = np.float32([[[2, -1, -1], [2, 3, -1], [2, -1, 3]],
                    [[4, -1, -1], [4, 5, -1], [4, -1, 5]],
                    [[6.5, -1, -1], [6.5, 5, -1], [6.5, -1, 5]],
                    [[8, 3, 3], [8, 7, 3], [8, 3, 7]]])
    tris = np.zeros((4, cluster.TRI_COLS, cluster.CLUSTER), np.float32)
    tris[:, 0:3, 0] = v[:, 0]
    tris[:, 3:6, 0] = v[:, 1] - v[:, 0]
    tris[:, 6:9, 0] = v[:, 2] - v[:, 0]
    tris[:, 9:11, 0] = 1.0  # valid, opaque
    tris[:, 11, 0] = np.arange(4)
    cboxes = np.zeros((4, 8), np.float32)
    cboxes[:, 0:6] = boxes
    positions = v.transpose(1, 0, 2).reshape(-1, 3)
    idx = np.arange(4)
    triangles = np.stack([idx, idx + 4, idx + 8], 1).astype(np.int32)
    inf = np.float32(np.inf)
    # P+, Q+, S+, P-, Q+ with t_max 3, a miss, a dead ray
    o = np.float32([[0, 0, 0], [0, 1.5, 1.5], [0, 4, 4], [10, 0, 0], [0, 1.5, 1.5],
                    [0, 20, 20], [0, 0, 0]])
    d = np.float32([[1, 0, 0]] * 3 + [[-1, 0, 0]] + [[1, 0, 0]] * 3)
    t_min = np.full(7, 1e-4, np.float32)
    t_max = np.float32([inf, inf, inf, inf, 3, inf, 0])
    want = {
        # P+ takes cluster 0 (t 2), which culls clusters 1 and 2; node 1's
        # cluster 3 lies past t 2. Q+ misses cluster 0's triangle and takes
        # cluster 1's (t 4), which culls cluster 2. P- takes cluster 2 (t
        # 3.5), which culls clusters 1 and 0; node 1's cluster 3 is still
        # in reach and tested. S+ tests every cluster and takes cluster 3.
        "slot": np.int32([0, 1, 3, 2, -1, -1, -1]),
        "t": np.float32([2, 4, 8, 3.5, inf, inf, inf]),
        "stats": np.int32([[2, 1, 1], [2, 2, 2], [2, 4, 4], [2, 2, 2], [2, 2, 2], [1, 0, 0],
                           [0, 0, 0]]),
        # any-hit stops at its first occluder, node 1 still on the stack
        "occ": np.bool_([1, 1, 1, 1, 0, 0, 0]),
        "stats_any": np.int32([[1, 1, 1], [1, 2, 2], [2, 4, 4], [1, 1, 1], [2, 2, 2],
                               [1, 0, 0], [0, 0, 0]]),
    }
    return (slab8, meta8, cboxes, tris), (positions, triangles), (o, d, t_min, t_max), want


def woop_ties_bvh8():
    """A hand-built 8-wide tree for the subpacket trace's Woop rows. Root
    (axis x): slot 0 cluster 0 (box x 0.5-2.5), slot 1 cluster 1 (x
    3.5-4.5), slot 2 interior node 1 (x 0-9), slot 3 cluster 2 (x 5.5-6.5);
    node 1: one leaf, cluster 3 (x 7.5-8.5, y, z 3-8). Cluster 0 holds three
    rows: row 0 a transparent triangle T in the plane x = 1 (y, z >= -1,
    y + z <= -0.5; slot 7), rows 1 and 2 one triangle A twice in the plane
    x = 2 (y, z >= -1, y + z <= 2), the lower row with the higher slot (5,
    then 4), so they tie in t; clusters 1 and 2 one triangle each in the
    planes x = 4 and 6 (y + z <= 4; slots 1, 2), cluster 3 one in x = 8 (y,
    z >= 3, y + z <= 10; slot 3); every triangle but T opaque. Rays: R0
    along +x through (y, z) = (-0.5, -0.5) (T, then A), R1 through (0.5,
    0.5) (A only), S through (4, 4) (cluster 3 only), Q along -x from x =
    10 through (0.5, 0.5), T0 as R0 with t_max 1.5 (only T in reach), one
    that misses the root's children and a dead one. A pop of the root hits
    up to three leaf clusters along the ray, all tested (no box re-test).
    Returns the tables (slab8, meta8, woop), the cluster triangle blocks
    (C, 16, 128), the rays (o, d, t_min, t_max) and what the walk must give:
    closest slot, its t (within 1e-6: the Woop arithmetic rounds) and
    per-ray (pops, leaves, rows), any-hit occlusion and its counts."""
    from luisarender_tpu_torch.ops import cluster, subpacket

    big = cluster._BIG
    table8 = np.zeros((2, 64), np.float32)
    table8[:, 0::8], table8[:, 3::8] = big, -big  # empty slots

    def child(node, slot, lo, hi, code):
        table8[node, 8 * slot:8 * slot + 3] = lo
        table8[node, 8 * slot + 3:8 * slot + 6] = hi
        table8[node, 8 * slot + 6] = code

    boxes = np.float32([[0.5, -1, -1, 2.5, 5, 5], [3.5, -1, -1, 4.5, 5, 5],
                        [5.5, -1, -1, 6.5, 5, 5], [7.5, 3, 3, 8.5, 8, 8]])
    for slot, c in ((0, 0), (1, 1), (3, 2)):
        child(0, slot, boxes[c, :3], boxes[c, 3:], -c - 1.0)
    child(0, 2, (0, -1, -1), (9, 8, 8), 1.0)
    child(1, 0, boxes[3, :3], boxes[3, 3:], -4.0)
    table8[:, 7] = 0.0  # sort axis x
    slab8, meta8 = subpacket.build_slab_meta(table8)
    tri_t = [[1, -1, -1], [1, 0.5, -1], [1, -1, 0.5]]
    tri_a = [[2, -1, -1], [2, 3, -1], [2, -1, 3]]
    # (cluster, row, vertices, opaque, slot)
    rows = [(0, 0, tri_t, 0.0, 7), (0, 1, tri_a, 1.0, 5), (0, 2, tri_a, 1.0, 4),
            (1, 0, [[4, -1, -1], [4, 5, -1], [4, -1, 5]], 1.0, 1),
            (2, 0, [[6, -1, -1], [6, 5, -1], [6, -1, 5]], 1.0, 2),
            (3, 0, [[8, 3, 3], [8, 7, 3], [8, 3, 7]], 1.0, 3)]
    tris = np.zeros((4, cluster.TRI_COLS, cluster.CLUSTER), np.float32)
    for c, j, v, opq, slot in rows:
        v = np.float32(v)
        tris[c, 0:3, j] = v[0]
        tris[c, 3:6, j] = v[1] - v[0]
        tris[c, 6:9, j] = v[2] - v[0]
        tris[c, 9:12, j] = (1.0, opq, slot)  # valid, opaque, slot
    inf = np.float32(np.inf)
    # R0, R1, S, Q, T0, a miss, a dead ray
    o = np.float32([[0, -0.5, -0.5], [0, 0.5, 0.5], [0, 4, 4], [10, 0.5, 0.5],
                    [0, -0.5, -0.5], [0, 20, 20], [0, 0, 0]])
    d = np.float32([[1, 0, 0]] * 3 + [[-1, 0, 0]] + [[1, 0, 0]] * 3)
    t_min = np.full(7, 1e-4, np.float32)
    t_max = np.float32([inf, inf, inf, inf, 1.5, inf, 0])
    want = {
        # R0: T (t 1) beats A (t 2). R1: A's two rows tie at t 2, the least
        # slot (4, row 2) wins. S tests every cluster and takes cluster 3.
        # Q takes cluster 2 (t 4) and still tests clusters 1 and 0. T0 only
        # reaches cluster 0, and T. Closest hits test every leaf of the
        # root's pop; node 1's cluster 3 is in reach of S alone.
        "slot": np.int32([7, 4, 3, 2, 7, -1, -1]),
        "t": np.float32([1, 2, 8, 4, 1, inf, inf]),
        "stats": np.int32([[2, 3, 5], [2, 3, 5], [2, 4, 6], [2, 3, 5], [2, 1, 3], [1, 0, 0],
                           [0, 0, 0]]),
        # any-hit: T does not occlude; R0 and R1 stop at A's row 1 (two
        # rows tested), Q at cluster 2, node 1 still on the stack; T0 is
        # not occluded
        "occ": np.bool_([1, 1, 1, 1, 0, 0, 0]),
        "stats_any": np.int32([[1, 1, 2], [1, 1, 2], [2, 4, 6], [1, 1, 1], [2, 1, 3],
                               [1, 0, 0], [0, 0, 0]]),
    }
    return ((slab8, meta8, subpacket.build_woop_table(tris)), tris, (o, d, t_min, t_max),
            want)


def box_obj(tmp_path):
    """The reference's two-level test mesh (tests/test_twolevel.py
    `_box_obj`): a 12-triangle cube [-1, 1]^3 as an OBJ file in tmp_path."""
    p = tmp_path / "box.obj"
    verts = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
             (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
    faces = [(1, 3, 2), (1, 4, 3), (5, 6, 7), (5, 7, 8), (1, 2, 6), (1, 6, 5),
             (2, 3, 7), (2, 7, 6), (3, 4, 8), (3, 8, 7), (4, 1, 5), (4, 5, 8)]
    lines = [f"v {x} {y} {z}" for x, y, z in verts]
    lines += [f"f {a} {b} {c}" for a, b, c in faces]
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def instanced_scene(tmp_path, accel, grouped=False, res=48, spp=16, depth=3):
    """The reference's two-level test scene (tests/test_twolevel.py
    `_instanced_scene`): four instances of one box OBJ, translated to (-3,
    0), (0, 0), (3, 0), (0, 3) and scaled in y by 1.0-1.6, under an area
    light quad at y = 6, seen from (0, 2, 12); here instances 1 and 3 are
    red and 0 and 2 white. `grouped` builds the boxes as `instance` shapes
    of one named mesh node inside a `group` whose surface (white) they
    inherit, instances 1 and 3 with their own (red), and instance 2 with
    `visible: false` (seen by no two-level trace; a flattened scene ignores
    the flag), and adds a quad with a `null` surface in front of box 0,
    which blocks no shadow ray."""
    box = box_obj(tmp_path)

    def matte(rgb):
        return {"impl": "matte", "prop": {"Kd": {"impl": "constant", "prop": {"v": rgb}}}}

    white, red = matte([0.7, 0.7, 0.7]), matte([0.7, 0.2, 0.2])
    boxes = []
    for i, (tx, ty) in enumerate([(-3, 0), (0, 0), (3, 0), (0, 3)]):
        prop = {"transform": {"impl": "srt", "prop": {
            "translate": [float(tx), float(ty), 0.0], "scale": [1.0, 1.0 + 0.2 * i, 1.0]}}}
        if grouped:
            prop["shape"] = "@box"
            if i % 2:
                prop["surface"] = red
            if i == 2:
                prop["visible"] = False
            boxes.append({"impl": "instance", "prop": prop})
        else:
            prop.update(file=box, surface=red if i % 2 else white)
            boxes.append({"impl": "mesh", "prop": prop})
    shapes = boxes
    if grouped:
        # a null-surface quad in front of the box at x = -3: closest hits
        # stop there, shadow rays pass (it blocks nothing)
        shapes = [{"impl": "group", "prop": {"surface": white, "shapes": boxes}},
                  {"impl": "inlinemesh", "prop": {
                      "positions": [-4.5, -1, 1.5, -1.5, -1, 1.5, -1.5, 1, 1.5, -4.5, 1, 1.5],
                      "indices": [0, 1, 2, 0, 2, 3], "surface": {"impl": "null", "prop": {}}}}]
    shapes.append({"impl": "inlinemesh", "prop": {
        "positions": [-2, 6, -2, 2, 6, -2, 2, 6, 2, -2, 6, 2],
        "indices": [0, 1, 2, 0, 2, 3],  # ng points down (-y)
        "surface": white,
        "light": {"impl": "diffuse", "prop": {
            "emission": {"impl": "constant", "prop": {"v": [10, 10, 10]}}}},
    }})
    d = {"render": {
        "accel": accel,
        "cameras": [{"impl": "pinhole", "prop": {
            "fov": 50.0, "spp": spp, "file": "out.exr",
            "film": {"impl": "color", "prop": {"resolution": [res, res]}},
            "transform": {"impl": "view", "prop": {"origin": [0.0, 2.0, 12.0],
                                                   "front": [0, -0.1, -1]}},
        }}],
        "integrator": {"impl": "megapath", "prop": {"depth": depth}},
        "shapes": shapes,
    }}
    if grouped:
        d["box"] = {"type": "shape", "impl": "mesh", "prop": {"file": box}}
    return d


def instanced_rays(n=2048, seed=7):
    """Rays at the instanced scene as float32 numpy (o, d, t_min, t_max):
    `n` from around the camera biased towards the boxes (the reference's
    tests/test_twolevel.py rays), then 64 each along -z, +x, -y and +y
    (zero direction components: the TLAS's padded leaves pass their slab
    test there) through the boxes and the light, and every 17th lane of
    the first n dead."""
    rs = np.random.RandomState(seed)
    o = rs.randn(n, 3).astype(np.float32) * 0.5 + np.asarray([0, 2, 12], np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rng = np.random.default_rng(seed)
    axis_o, axis_d = [], []
    for start, direction in (((None, None, 12.0), (0, 0, -1)), ((-6.0, None, None), (1, 0, 0)),
                             ((None, 5.9, None), (0, -1, 0)), ((None, -3.0, None), (0, 1, 0))):
        pts = np.stack([rng.uniform(-4.5, 4.5, 64), rng.uniform(-1.5, 5.5, 64),
                        rng.uniform(-1.5, 1.5, 64)], -1)
        for k, v in enumerate(start):
            if v is not None:
                pts[:, k] = v
        axis_o.append(pts)
        axis_d.append(np.tile(np.float32(direction), (64, 1)))
    o = np.concatenate([o] + axis_o).astype(np.float32)
    d = np.concatenate([d] + axis_d).astype(np.float32)
    t_min = np.full(o.shape[0], 1e-4, np.float32)
    t_max = np.full(o.shape[0], np.inf, np.float32)
    t_max[:n:17] = 0.0
    return o, d, t_min, t_max
