"""The port's photon mapping (luisarender_tpu_torch/integrators/megapm.py,
`photon` and its aliases) against the JAX package's, on the CPU, on
testing.cornell_box at 16^2 with the reference's defaults (65,536 photons a
iteration, a 64^3 grid, 32 photons a cell) but for shorter walks (3 photon
bounces, 2 camera bounces; the golden renders the default 5 and 4):

(a) the world bounds both compilers store, bit for bit, on the Cornell
    box and on scenes/materials.json (four analytic spheres), and the SPPM
    radii the port computes from them, bit for bit against the
    reference's rule;
(b) DiffuseLight.sample_le on equal uniforms: the point, the direction and
    the weight within 1e-5;
(c) iteration 0's photons (the reference's _emit_photons, jitted once with
    the rest of the iteration): the valid mask equal on at least 99.9% of
    the slots, positions within 1e-4 of the world's diagonal, power and
    directions within 1e-4 where both are valid;
(d) the grid built by both from the reference's photons: no cell holds more
    than cell_budget photons on either side (the reference sorts cells
    unstably, so an overflowing cell would keep other survivors), cellrow
    equal, each row the same photons once sorted within it;
(e) the gather on equal inputs (the reference's grid, gather points on the
    box's walls) within 1e-5 relative, in blocks or whole;
(f) iteration 0's image by the goldens' rule: under 2% of pixels off by
    more than 1e-3;
(g) a 32^2, 4-spp render through render_file against
    tests/golden/photon_32_4spp.exr (the reference's CPU render) by the
    goldens' rule, the mean within 0.5%.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.lights.base import dispatch_sample_le
from luisarender_tpu_torch.utils import imageio

import torch_parity

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "photon_32_4spp.exr"
RES = 16
N_LE = 4096  # photons of the sample_le case
# the parity cases' walks: 3 photon bounces (2 deposits a photon) and 2
# camera bounces, the reference's defaults' code at about half its
# compile time; the golden renders the defaults (5 and 4)
PARITY = {"photon_depth": 3, "depth": 2}


def _scene(res=RES, spp=1, **props):
    d = testing.cornell_box(resolution=(res, res), spp=spp, depth=6)
    d["render"]["integrator"] = {"impl": "photon", "prop": {"depth": 6, **props}}
    return d


def _pixels(w, h):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)


def _gather_inputs(k=600, seed=5):
    """Gather points on the box's floor, ceiling and three walls (the
    surfaces photons land on), with their inward normals, positive
    coefficients and a validity mask, from a seed."""
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(20.0, 530.0, (2, k))
    face = rng.integers(0, 5, k)
    zero = np.zeros(k)
    planes = [  # (point, normal) of floor, ceiling, back, left, right
        (np.stack([a, zero, b], 1), (0, 1, 0)),
        (np.stack([a, zero + 548.8, b], 1), (0, -1, 0)),
        (np.stack([a, b, zero + 559.2], 1), (0, 0, -1)),
        (np.stack([zero + 550.0, a, b], 1), (-1, 0, 0)),
        (np.stack([zero, a, b], 1), (1, 0, 0)),
    ]
    gp_p = np.select([face[:, None] == i for i in range(5)], [q for q, _ in planes])
    gp_ns = np.asarray([nrm for _, nrm in planes], np.float64)[face]
    gp_ns = gp_ns + rng.normal(0.0, 0.2, (k, 3))
    gp_ns /= np.linalg.norm(gp_ns, axis=1, keepdims=True)
    gp_coef = rng.uniform(0.1, 1.0, (k, 3))
    gp_valid = rng.uniform(size=k) < 0.9
    return (gp_p.astype(np.float32), gp_ns.astype(np.float32), gp_coef.astype(np.float32),
            gp_valid)


@pytest.fixture(scope="module")
def case():
    """Both packages' compiled scene and the reference's iteration 0,
    jitted once: its photons, grid, image and a gather on given points."""
    torch_parity.require_reference_builder()
    d = _scene(**PARITY)
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    ji, ti = jscene.integrator, tscene.integrator
    radius = np.float32(ti.radii(tcomp, 1)[0])
    pxy = _pixels(RES, RES)
    n_emitted = jnp.float32(ji.photons_per_iter)

    def iteration(arrays, r, gp, u_pos, u_dir):
        photons = ji._emit_photons(jcomp, arrays, 0)
        grid = ji._build_grid(jcomp, arrays, photons, r)
        rgb, _ = ji._camera_pass(jcomp, arrays, jscene.cameras[0], jnp.asarray(pxy), 0, grid,
                                 r, n_emitted)
        gathered = ji._gather(arrays, *gp, grid, r, n_emitted)
        return photons, grid, rgb, gathered, _reference_sample_le(jcomp, arrays, u_pos, u_dir)

    gp = _gather_inputs()
    rng = np.random.default_rng(3)
    u_pos, u_dir = rng.uniform(size=(2, N_LE, 2)).astype(np.float32)
    photons, grid, rgb, gathered, le = jax.device_get(jax.jit(iteration)(
        jcomp.arrays, jnp.float32(radius), tuple(jnp.asarray(x) for x in gp),
        jnp.asarray(u_pos), jnp.asarray(u_dir)))
    return {"jcomp": jcomp, "tcomp": tcomp, "tscene": tscene, "ti": ti, "ji": ji,
            "radius": radius, "photons": photons, "grid": grid, "rgb": rgb, "gp": gp,
            "gathered": gathered, "pxy": pxy, "le": (u_pos, u_dir, le)}


def _reference_sample_le(jcomp, arrays, u_pos, u_dir):
    """The reference's DiffuseLight.sample_le on light entry 0, its rows
    gathered as its _emit_photons gathers them."""
    from luisarender_tpu.core.fetch import gather_param_rows
    from luisarender_tpu.lights.diffuse import DiffuseLight as JDiffuse

    n = u_pos.shape[0]
    ctx = jcomp.context(arrays)
    entries = {k: v[jnp.zeros((n,), jnp.int32)] for k, v in arrays["light_entries"].items()}
    index = arrays["instances"]["light_index"][entries["inst"]]
    rows = gather_param_rows(ctx.arrays["lights"][0], index)
    swl = jcomp.spectrum.sample_wavelengths(jnp.zeros((n, 1), jnp.float32))
    return JDiffuse.sample_le(rows, ctx, entries, u_pos, u_dir, swl)


@pytest.fixture(scope="module")
def port_photons(case):
    return case["ti"]._emit_photons(case["tcomp"], 0)


# ---------------------------------------------------------------------------
# (a) world bounds and radii
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["cornell", "materials"])
def test_world_bounds_match_reference(which, case):
    if which == "cornell":
        jcomp, tcomp = case["jcomp"], case["tcomp"]
    else:
        path = str(ROOT / "scenes" / "materials.json")
        jcomp = lr.compile_scene(lr.load_scene(path))
        tcomp = lt.compile_scene(lt.load_scene(path), device="cpu")
        assert tcomp.plan.num_spheres == 4
    for key in ("world_min", "world_max"):
        got = tcomp.arrays[key].numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(jcomp.arrays[key]), err_msg=key)


def test_radii_match_reference_rule(case):
    ji, ti = case["ji"], case["ti"]
    arrays = case["jcomp"].arrays
    # the reference's schedule (megapm.py _render_one_camera)
    r = float(np.linalg.norm(np.asarray(arrays["world_max"]) - np.asarray(arrays["world_min"])))
    r *= ji.initial_radius_scale
    want = np.empty((16,), np.float32)
    for i in range(16):
        want[i] = r
        r = float(np.sqrt(r * r * (i + ji.alpha) / (i + 1.0)))
    got = ti.radii(case["tcomp"], 16)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) < 0)


# ---------------------------------------------------------------------------
# (b) photon emission from the light
# ---------------------------------------------------------------------------


def test_sample_le_matches_reference(case):
    tcomp = case["tcomp"]
    u_pos, u_dir, ref = case["le"]
    tswl = tcomp.spectrum.sample_wavelengths(torch.zeros((N_LE, 1)))
    got = dispatch_sample_le(tcomp, torch.zeros(N_LE, dtype=torch.int64),
                             torch.as_tensor(u_pos), torch.as_tensor(u_dir), tswl)
    for k in ("p", "ng", "wi", "weight"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # the light faces down: every photon leaves downwards
    assert (got["wi"][:, 1] < 0).all()


# ---------------------------------------------------------------------------
# (c) iteration 0's photons
# ---------------------------------------------------------------------------


def test_emit_photons_match_reference(case, port_photons):
    p_ref, pow_ref, wi_ref, v_ref = case["photons"]
    p, power, wi, valid = (x.numpy() for x in port_photons)
    assert p.shape == p_ref.shape and power.shape == pow_ref.shape
    assert valid.shape == v_ref.shape == (2 * case["ti"].photons_per_iter,)
    assert (valid == v_ref).mean() >= 0.999
    both = valid & v_ref
    assert both.sum() > 30_000
    # positions within 1e-4 of the world's diagonal (XLA contracts the
    # reference's multiply-adds, and four bounces carry a direction's last
    # bits ~500 units)
    tcomp = case["tcomp"]
    diag = float((tcomp.arrays["world_max"] - tcomp.arrays["world_min"]).norm())
    assert np.abs(p[both] - p_ref[both]).max() < 1e-4 * diag
    np.testing.assert_allclose(power[both], pow_ref[both], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wi[both], wi_ref[both], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# (d) the grid
# ---------------------------------------------------------------------------


def _cell_counts(p, valid, wmin, wmax, g):
    ext = np.maximum(wmax - wmin, 1e-6)
    cell = np.clip(((p - wmin) / ext * g).astype(np.int32), 0, g - 1)
    cid = (cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]
    return np.bincount(cid[valid], minlength=g ** 3)


def _sorted_rows(table, f, budget):
    """Each row's photons (budget, f), sorted lexicographically."""
    ph = table.reshape(-1, f, budget).transpose(0, 2, 1)
    out = np.empty_like(ph)
    for i, row in enumerate(ph):
        out[i] = row[np.lexsort(row.T[::-1])]
    return out


def test_grid_matches_reference(case, port_photons):
    ti, tcomp = case["ti"], case["tcomp"]
    wmin, wmax = (tcomp.arrays[k].numpy() for k in ("world_min", "world_max"))
    g, budget = ti.grid_res, ti.cell_budget
    # no cell overflows, on either side: the tie order inside a cell then
    # only orders its summands
    for p, _, _, valid in (case["photons"], [x.numpy() for x in port_photons]):
        counts = _cell_counts(p, valid, wmin, wmax, g)
        assert 0 < counts.max() <= budget
        assert (counts > 0).sum() <= ti.table_rows
    cellrow_ref, table_ref = case["grid"]
    cellrow, table = ti._build_grid(tcomp, tuple(torch.tensor(x) for x in case["photons"]))
    np.testing.assert_array_equal(cellrow.numpy(), cellrow_ref)
    assert table.shape == table_ref.shape == (ti.table_rows + 1, 10 * budget)
    used = int((cellrow_ref >= 0).sum())
    np.testing.assert_array_equal(_sorted_rows(table.numpy()[:used], 10, budget),
                                  _sorted_rows(table_ref[:used], 10, budget))
    assert not table[used:].any() and not table_ref[used:].any()


# ---------------------------------------------------------------------------
# (e) the gather, (f) iteration 0's image
# ---------------------------------------------------------------------------


def test_gather_matches_reference(case):
    ti = case["ti"]
    grid = tuple(torch.as_tensor(x) for x in case["grid"])
    gp = [torch.as_tensor(x) for x in case["gp"]]
    got = ti._gather(case["tcomp"], *gp, grid, case["radius"], ti.photons_per_iter).numpy()
    want = case["gathered"]
    assert (want > 0).any(axis=-1).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_gather_blocks_leave_the_sums(case, monkeypatch):
    from luisarender_tpu_torch.integrators import megapm

    ti = case["ti"]
    grid = tuple(torch.as_tensor(x) for x in case["grid"])
    gp = [torch.as_tensor(x) for x in case["gp"]]
    whole = ti._gather(case["tcomp"], *gp, grid, case["radius"], ti.photons_per_iter)
    monkeypatch.setattr(megapm, "GATHER_BLOCK", 97)
    blocked = ti._gather(case["tcomp"], *gp, grid, case["radius"], ti.photons_per_iter)
    assert torch.equal(whole, blocked)


def test_iteration_image_matches_reference(case):
    ti, tscene = case["ti"], case["tscene"]
    rgb, weight = ti.iteration(case["tcomp"], tscene.cameras[0],
                               torch.as_tensor(case["pxy"]), 0, case["radius"])
    rgb = rgb.numpy()
    assert np.isfinite(rgb).all() and torch.equal(weight, torch.ones(RES * RES))
    assert (np.abs(rgb - case["rgb"]).max(-1) > 1e-3).mean() < 0.02
    assert rgb.mean() > 0.01


# ---------------------------------------------------------------------------
# (g) the golden, through render_file
# ---------------------------------------------------------------------------


def test_render_file_matches_golden(tmp_path):
    d = _scene(res=32, spp=4)
    d["render"]["cameras"][0]["prop"]["file"] = str(tmp_path / "photon.exr")
    path = tmp_path / "photon.json"
    path.write_text(json.dumps(d))
    img = lt.render_file(str(path), save=True, device="cpu")[str(tmp_path / "photon.exr")]
    ref = imageio.load_exr(str(GOLDEN))
    assert img.shape == ref.shape == (32, 32, 3) and np.isfinite(img).all()
    np.testing.assert_array_equal(imageio.load_exr(str(tmp_path / "photon.exr")), img)
    assert (np.abs(img - ref).max(-1) > 1e-3).mean() < 0.02
    assert abs(img.mean() / ref.mean() - 1.0) < 0.005
