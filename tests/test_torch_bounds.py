"""chip_smoke.py's bound of the brute-force kernels (brute_work,
kernel_bounds) on hand-made rays, on the CPU: each row test is counted to
its first failed check of the plain arithmetic, any-hit up to its first
occluder among the opaque rows, and a dead lane counts no rows and no ray
bytes. Its bound of the subpacket kernels (tree_bound) on
torch_parity.woop_ties_bvh8: the bytes of the rays, the popped nodes and
13 (or 22) columns of each valid row of the tested clusters, and one of
each padding row; of the binary-tree kernel, on torch_parity.tie_tree,
for its pair walk (two boxes and two codes a pair row visited, two box
tests a visit) and for the walk in the reference's order (a node's box,
skip, count and first a node popped, one box test a pop), both with the
ten columns of each row tested. Its bound of the fused kernel's environment mode
(plain_counted, fused_bound) on a 16^2 env Cornell box: the candidates
that NEE picks and the area-light samples it takes, and no others; and of
its ray-input mode on the ray scenes (ray_scene, ray_inputs): the 40 B ray
a lane in its bytes.

The row is the triangle v0 = 0, e1 = x, e2 = y; a ray from (x, y, 1) along
-z meets it at u = x, v = y, t = 1, exactly in float32.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from luisarender_tpu_torch.ops import brute  # noqa: E402

# (x, y) of each ray and what its test of the row costs
RAYS = [
    ((0.25, 0.25), cs.FLOPS_PER_ROW),  # inside: the whole test
    ((1.5, 0.2), cs.OPS_TO_U),  # u > 1
    ((-0.5, 0.2), cs.OPS_TO_U),  # u < 0
    ((0.5, -0.2), cs.OPS_TO_V),  # v < 0
    ((0.6, 0.6), cs.OPS_TO_SUM),  # u + v > 1
    ((0.25, 0.25), 0),  # dead lane (t_max = 0)
]


def _table(opaque):
    """One row per entry of `opaque`, all the same triangle, all valid."""
    table = torch.zeros((len(opaque), brute.TRI_COLS))
    table[:, 3] = 1.0  # e1 = x
    table[:, 7] = 1.0  # e2 = y
    table[:, 9] = 1.0
    table[:, 10] = torch.tensor(opaque, dtype=torch.float32)
    return table


def _rays():
    o = torch.tensor([[x, y, 1.0] for (x, y), _ in RAYS])
    d = torch.tensor([[0.0, 0.0, -1.0]] * len(RAYS))
    t_min = torch.zeros(len(RAYS))
    t_max = torch.full((len(RAYS),), float("inf"))
    t_max[-1] = 0.0
    return o, d, t_min, t_max


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_brute_work_counts_each_test_to_its_exit(kind):
    """Three copies of the row, the first clear: closest tests all three on
    every live lane; any-hit skips the clear row and stops at the first
    opaque one that occludes (a miss tests both)."""
    o, d, t_min, t_max = _rays()
    table = _table([0.0, 1.0, 1.0])
    rows, ops = cs.brute_work(torch, brute, kind, o, d, t_min, t_max, table)
    cost = torch.tensor([c for _, c in RAYS])
    if kind == "closest":
        want_rows = torch.tensor([3, 3, 3, 3, 3, 0])
    else:
        want_rows = torch.tensor([1, 2, 2, 2, 2, 0])
        assert torch.equal(brute.any_plain(o, d, t_min, t_max, table), want_rows == 1)
    assert torch.equal(rows, want_rows)
    assert torch.equal(ops, want_rows * cost)


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_kernel_bounds_counts_rays_of_live_lanes(kind):
    """Bytes: t_min, t_max and the outputs of every lane, o and d of live
    lanes, the table once; operations: brute_work's sum."""
    o, d, t_min, t_max = _rays()
    table = _table([1.0, 1.0])
    rows, ops = cs.brute_work(torch, brute, kind, o, d, t_min, t_max, table)
    n, live = len(RAYS), len(RAYS) - 1
    nbytes = n * (8 + (16 if kind == "closest" else 1)) + live * 24 + table.numel() * 4
    ms, by = cs.kernel_bounds(torch, kind, rows, ops, table)
    t_bytes = nbytes / cs.PEAK_BYTES_PER_S * 1e3
    t_ops = int(ops.sum()) / cs.PEAK_FP32_PER_S * 1e3
    assert ms == max(t_bytes, t_ops)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_subpacket_bound_counts_woop_columns(kind):
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_parity import woop_ties_bvh8

    from luisarender_tpu_torch.ops import subpacket

    tables, _, rays, _ = woop_ties_bvh8()
    tables = tuple(torch.as_tensor(x) for x in tables)
    rays = tuple(torch.as_tensor(x) for x in rays)
    visited = (torch.zeros(2, dtype=torch.bool), torch.zeros(4, dtype=torch.bool))
    st = subpacket.subpacket_plain(*rays, *tables, kind == "any", visited)
    assert visited[0].tolist() == [True, True] and visited[1].tolist() == [True] * 4
    bounds = {cols: cs.tree_bound("subpacket", kind, tables, rays, st.stats, visited, 0,
                                  woop_cols=cols) for cols in (13, 22)}
    # 6 valid rows of 4 clusters, 506 padding rows; 7 rays in and out; 2 nodes
    out = 8 if kind == "closest" else 4
    base = 7 * (32 + out) + 2 * 57 * 4 + 506 * 4
    for cols, (ms, by) in bounds.items():
        assert by == "bytes"
        assert ms == pytest.approx((base + 6 * cols * 4) / cs.PEAK_BYTES_PER_S * 1e3, rel=1e-12)


@pytest.mark.parametrize("order", ["pairs", "preorder"])
def test_trace_bound_counts_the_walk(order):
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_parity import tie_tree

    from luisarender_tpu_torch.accel.traverse import TraceGeometry
    from luisarender_tpu_torch.ops import trace

    arrays, rays = tie_tree(False)
    nodes, tris = trace.pack_tables(TraceGeometry(
        num_rows=4, **{k: torch.as_tensor(v) for k, v in arrays.items()}))
    rays = tuple(torch.as_tensor(x) for x in rays)
    pairs = order == "pairs"
    visited = (torch.zeros(2 if pairs else 3, dtype=torch.bool),
               torch.zeros(4, dtype=torch.bool))
    walk = (trace.walk_plain if pairs else trace.preorder_plain)(*rays, nodes, tris, 4,
                                                                   visited)[4]
    # 62 rays through both leaves, one that misses the root's box, one dead
    per_ray = 2 if pairs else 3  # pair rows 0 and 1; or the root and both leaves
    assert int(walk[:, 0].sum()) == 62 * per_ray + 1 and int(walk[:, 2].sum()) == 62 * 4
    assert bool(visited[0].all()) and bool(visited[1].all())
    ms, by = cs.tree_bound("trace" if pairs else "trace_preorder", "closest",
                           (nodes, tris, 4), rays, walk, visited, 1)
    nbytes = 64 * (32 + 16) + (2 * 14 if pairs else 3 * 9) * 4 + 4 * 10 * 4
    ops = (62 * per_ray + 1) * (2 if pairs else 1) * cs.FLOPS_PER_NODE + 248 * cs.FLOPS_PER_ROW
    assert by == "bytes" and nbytes / cs.PEAK_BYTES_PER_S > ops / cs.PEAK_FP32_PER_S
    assert ms == pytest.approx(nbytes / cs.PEAK_BYTES_PER_S * 1e3, rel=1e-12)


@pytest.mark.parametrize("kind", ["spherical", "env_only"])
def test_fused_env_bound_counts_the_picked_candidates(kind):
    """Every surface lane's NEE picks the environment or an area light
    (only the environment without area lights); a constant map's
    candidates all have pdf > 0. Bytes: 24 B of pixel ids, rgb and rays and
    28 B of escape state a lane, and 28 B a picked candidate; operations:
    the area-light sample (and u_sel's rest) only where NEE takes it, the
    environment's far point where it picks the environment."""
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid
    from luisarender_tpu_torch.ops import fused_path as fp

    res, depth = 16, 3
    scene = cs.env_scene(lt, kind, res=res, depth=depth)
    compiled = lt.compile_scene(scene, device="cpu")
    integ = scene.integrator
    cam = fp.camgen_params(scene.cameras[0], integ.sampler.seed)
    pxy = pixel_grid(res, res, "cpu")
    tables = fp.fused_tables(compiled)
    p_env = integ.light_sampler.selection_probs(compiled)[0]
    env = fp.EnvInputs(fp.env_nee_candidates(compiled, cam, pxy, 0, depth, p_env), p_env,
                       compiled.plan.env_distance)
    with cs.plain_counted(torch, fp, tables, pxy, env) as counts:
        fp.paths_plain(tables, cam, pxy, 0, 0, env=env, max_depth=depth,
                       rr_depth=integ.rr_depth, rr_threshold=integ.rr_threshold)
    surf = sum(counts["shaded_by_type"].values())
    assert counts["env_picked"] + counts["area_picked"] == surf
    if kind == "env_only":
        assert counts["area_picked"] == 0
    else:
        assert 0.3 * surf < counts["env_picked"] < 0.7 * surf
    assert counts["env_pdf_positive"] == counts["env_picked"]
    n = pxy.shape[0]
    b = cs.fused_bound(tables, counts, n, env=True)
    assert b["bytes"] == n * 52 + counts["env_picked"] * 28
    plain = cs.fused_bound(tables, counts, n)
    assert b["flops"] - plain["flops"] == (
        counts["area_picked"] * 2
        + counts["env_picked"] * (cs.FLOPS_ENV_PICK - cs.FLOPS_AREA_PICK))


@pytest.mark.parametrize("kind", ["thinlens", "mitchell_clip", "env_thinlens"])
def test_fused_ray_bound_counts_the_ray_words(kind):
    """The ray-input mode's bound on chip_smoke.py's ray scenes at 16^2:
    the 40 B ray a lane in place of the 8 B pixel ids, the same operations
    as the camgen mode's bound charges for the same counted work; every
    lane's camera ray is traced."""
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid
    from luisarender_tpu_torch.ops import fused_path as fp

    res, depth = 16, 3
    scene = cs.ray_scene(lt, kind, res=res, depth=depth)
    compiled = lt.compile_scene(scene, device="cpu")
    integ = scene.integrator
    assert fp.camgen_params(scene.cameras[0], integ.sampler.seed) is None
    pxy = pixel_grid(res, res, "cpu")
    rays, _, env = cs.ray_inputs(fp, compiled, scene, pxy, 0, depth)
    assert rays.shape == (fp.RAY_WORDS, res * res) and (env is not None) == (kind == "env_thinlens")
    tables = fp.fused_tables(compiled)
    with cs.plain_counted(torch, fp, tables, pxy, env) as counts:
        fp.paths_plain(tables, None, None, 0, 0, env=env, rays=rays, max_depth=depth,
                       rr_depth=integ.rr_depth, rr_threshold=integ.rr_threshold)
    n = res * res
    assert counts["closest"] >= n and counts["shaded"] > 0
    b = cs.fused_bound(tables, counts, n, env=env is not None, rays=True)
    camgen = cs.fused_bound(tables, counts, n, env=env is not None)
    assert b["bytes"] - camgen["bytes"] == n * (cs.RAY_BYTES - 8)
    assert b["flops"] == camgen["flops"] and b["matte_flops"] == camgen["matte_flops"]
