"""The port's media layer (luisarender_tpu_torch/core/medium_tracker.py,
phasefunctions/hg.py, media/base.py, media/grid.py) against the JAX
package on seeded numpy inputs, on the CPU:

(a) the tracker's pack / unpack / current / enter / exit_ bit for bit,
    on trackers with ties, empty slots and full stacks;
(b) hg_p and hg_sample within 1e-6, |g| < 1e-3 and negative g included;
(c) the homogeneous medium's transmittance and sample_distance within rtol
    1e-5, under sRGB and under the hero spectrum;
(d) the grid's trilinear density (z-major, 0 outside its bounds) within
    1e-6, and its tracking loops: ratio-tracking transmittance and
    spectral-MIS delta tracking on rays through testing.fog_grid's box,
    the `scattered` flags equal on at least 99.9% of lanes (an ulp of log
    may flip a step), t and the weights within rtol 1e-4 on the others;
(e) dispatch over a homogeneous and a grid type together, some lanes of
    neither and some outside `lanes`: the grid's lanes gathered out and
    scattered back give each lane the reference's compute-all result;
(f) the compiler's media tables, instance columns, density grids and plan
    fields equal the reference's on the fog scenes.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
from luisarender_tpu.core import medium_tracker as jmt
from luisarender_tpu.media import base as jmb
from luisarender_tpu.media import grid as jmg
from luisarender_tpu.phasefunctions import hg as jhg
import luisarender_tpu_torch as lt
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.core import medium_tracker as tmt
from luisarender_tpu_torch.media import base as tmb
from luisarender_tpu_torch.media import grid as tmg
from luisarender_tpu_torch.phasefunctions import hg as thg

import torch_parity

N = 4096


@pytest.fixture(autouse=True, scope="module")
def _reference_builder():
    torch_parity.require_reference_builder()


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the tracker
# ---------------------------------------------------------------------------


def _trackers(seed, n=512):
    """Random trackers: refs of 3 tags and 4 indices or empty, priorities
    from {-1, 0, 1, 2} (ties), some stacks full, some empty."""
    rs = np.random.RandomState(seed)
    k = tmt.CAPACITY
    tag = rs.randint(0, 3, (n, k))
    idx = rs.randint(0, 4, (n, k))
    ref = (tag << 16 | idx).astype(np.int32)
    empty = rs.rand(n, k) < 0.5
    empty[: n // 8] = False  # full stacks
    empty[n // 8: n // 4] = True  # empty ones
    ref[empty] = -1
    prio = rs.randint(-1, 3, (n, k)).astype(np.float32)
    prio[empty] = -np.inf
    return ref, prio, rs


def test_tracker_ops_bit_equal():
    ref, prio, rs = _trackers(3)
    n = ref.shape[0]
    jt = jmt.MediumTracker(jnp.asarray(ref), jnp.asarray(prio))
    tt = tmt.MediumTracker(torch.as_tensor(ref), torch.as_tensor(prio))

    jh, jr = jmt.current(jt)
    th, tr = tmt.current(tt)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    jtag, jidx = jmt.unpack_ref(jr)
    ttag, tidx = tmt.unpack_ref(tr)
    np.testing.assert_array_equal(ttag.numpy(), np.asarray(jtag))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tmt.unpack_ref(torch.tensor([-1], dtype=torch.int32)) == (-1, 65535)

    tags = rs.randint(-1, 3, n).astype(np.int32)
    idxs = rs.randint(0, 4, n).astype(np.int32)
    np.testing.assert_array_equal(
        tmt.pack_ref(torch.as_tensor(tags), torch.as_tensor(idxs)).numpy(),
        np.asarray(jmt.pack_ref(jnp.asarray(tags), jnp.asarray(idxs))))

    mask = rs.rand(n) < 0.7
    new_ref = ref[np.arange(n), rs.randint(0, tmt.CAPACITY, n)]  # often one present
    new_ref = np.where(new_ref < 0, (tags.clip(0) << 16 | idxs), new_ref).astype(np.int32)
    new_prio = rs.randint(-1, 3, n).astype(np.float32)
    for op in ("enter", "exit_"):
        jargs = (jnp.asarray(mask), jnp.asarray(new_ref))
        targs = (torch.as_tensor(mask), torch.as_tensor(new_ref))
        if op == "enter":
            jargs += (jnp.asarray(new_prio),)
            targs += (torch.as_tensor(new_prio),)
        jo = getattr(jmt, op)(jt, *jargs)
        to = getattr(tmt, op)(tt, *targs)
        np.testing.assert_array_equal(to.ref.numpy(), np.asarray(jo.ref), op)
        np.testing.assert_array_equal(to.priority.numpy(), np.asarray(jo.priority), op)
    fresh = tmt.make_tracker((5,))
    jfresh = jmt.make_tracker((5,))
    np.testing.assert_array_equal(fresh.ref.numpy(), np.asarray(jfresh.ref))
    np.testing.assert_array_equal(fresh.priority.numpy(), np.asarray(jfresh.priority))


# ---------------------------------------------------------------------------
# (b) Henyey-Greenstein
# ---------------------------------------------------------------------------


def test_hg_matches_reference():
    rs = np.random.RandomState(5)
    wo = _unit(rs, N)
    u = rs.rand(N, 2).astype(np.float32)
    g = rs.choice([-0.8, -0.3, -5e-4, 0.0, 2e-4, 0.3, 0.9], N).astype(np.float32)
    cos_t = rs.uniform(-1, 1, N).astype(np.float32)
    np.testing.assert_allclose(thg.hg_p(torch.as_tensor(cos_t), torch.as_tensor(g)).numpy(),
                               np.asarray(jhg.hg_p(jnp.asarray(cos_t), jnp.asarray(g))),
                               rtol=1e-6, atol=1e-6)
    wi_t, pdf_t = thg.hg_sample(torch.as_tensor(wo), torch.as_tensor(u), torch.as_tensor(g))
    wi_j, pdf_j = jhg.hg_sample(jnp.asarray(wo), jnp.asarray(u), jnp.asarray(g))
    np.testing.assert_allclose(wi_t.numpy(), np.asarray(wi_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# (c) homogeneous, (d) grid, (e) dispatch
# ---------------------------------------------------------------------------


def _spectra(hero):
    d = testing.cornell_box(resolution=(4, 4), spp=1)
    if hero:
        d["render"]["spectrum"] = {"impl": "hero", "prop": {"dimension": 4}}
    jspec = lr.Scene.from_dict(d).spectrum.model()
    tspec = lt.Scene.from_dict(d).spectrum.model()
    u = np.random.RandomState(9).rand(N, 1).astype(np.float32)
    return (SimpleNamespace(spectrum=jspec), jspec.sample_wavelengths(jnp.asarray(u)),
            SimpleNamespace(spectrum=tspec), tspec.sample_wavelengths(torch.as_tensor(u)))


def _homog_params(rs, n):
    return {"sigma_a": rs.uniform(0, 0.5, (n, 3)).astype(np.float32),
            "sigma_s": rs.uniform(0, 0.5, (n, 3)).astype(np.float32),
            "g": rs.uniform(-0.5, 0.8, n).astype(np.float32)}


@pytest.mark.parametrize("hero", [False, True], ids=["srgb", "hero"])
def test_homogeneous_matches_reference(hero):
    jctx, jswl, tctx, tswl = _spectra(hero)
    rs = np.random.RandomState(11)
    p = _homog_params(rs, N)
    p["sigma_a"][:64] = 0.0  # a channel without extinction
    p["sigma_s"][:64, 0] = 0.0
    t_max = rs.uniform(0, 20, N).astype(np.float32)
    t_max[::50] = 1e8
    u_ch, u_d = (rs.rand(N).astype(np.float32) for _ in range(2))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jtr = jmb.HomogeneousMedium.transmittance(jp, jctx, jswl, jnp.asarray(t_max))
    ttr = tmb.HomogeneousMedium.transmittance(tp, tctx, tswl, torch.as_tensor(t_max))
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), rtol=1e-5, atol=1e-7)
    j = jmb.HomogeneousMedium.sample_distance(jp, jctx, jswl, jnp.asarray(t_max),
                                              jnp.asarray(u_ch), jnp.asarray(u_d))
    t = tmb.HomogeneousMedium.sample_distance(tp, tctx, tswl, torch.as_tensor(t_max),
                                              torch.as_tensor(u_ch), torch.as_tensor(u_d))
    np.testing.assert_array_equal(t["scattered"].numpy(), np.asarray(j["scattered"]))
    assert 0.1 < float(t["scattered"].float().mean()) < 0.9
    for k in ("t", "weight", "g"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


_GRID = {}


def _grid_scenes():
    """The fog scene with a small non-cubic grid (8 x 6 x 5) through both
    compilers (cached for the module)."""
    if not _GRID:
        d = testing.fog_grid((8, 8), 1, 4, dims=(8, 6, 5), seed=3)
        jc = lr.compile_scene(lr.Scene.from_dict(d))
        tc = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
        _GRID.update(d=d, jc=jc, jctx=jc.context(jc.arrays), tc=tc)
    return _GRID


def _grid_rows(g):
    assert [c.__name__ for c in g["tc"].plan.medium_types] == ["GridMedium"]
    jrows = {k: v for k, v in g["jctx"].arrays["media"][0].items()}
    trows = g["tc"].arrays["media"][0]
    return jrows, trows


def _rays(rs, n):
    """Rays from around the fog box towards random points in it."""
    lo, hi = (np.asarray(b, np.float32) for b in testing.FOG_BOUNDS)
    o = rs.uniform(lo - 60, hi + 60, (n, 3)).astype(np.float32)
    target = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def test_grid_density_matches_reference():
    g = _grid_scenes()
    jrows, trows = _grid_rows(g)
    rs = np.random.RandomState(13)
    lo, hi = (np.asarray(b, np.float32) for b in testing.FOG_BOUNDS)
    p = rs.uniform(lo - 20, hi + 20, (N, 3)).astype(np.float32)
    p[:8] = [lo, hi, [lo[0], hi[1], lo[2]], (lo + hi) / 2, lo - 1e-3, hi + 1e-3,
             [hi[0], lo[1], hi[2]], [lo[0], (lo[1] + hi[1]) / 2, hi[2]]]
    jr = {k: jnp.broadcast_to(v[0], (N,) + v.shape[1:]) for k, v in jrows.items()}
    tr = {k: v[0].expand((N,) + tuple(v.shape[1:])) for k, v in trows.items()}
    want = np.asarray(jmg._density(jr, g["jctx"], jnp.asarray(p)))
    got = tmg._density(tr, g["tc"], torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (want == 0).mean() > 0.1 and (want > 0).mean() > 0.3


def _loop_inputs(seed):
    g = _grid_scenes()
    jrows, trows = _grid_rows(g)
    jctx, jswl, tctx, tswl = _spectra(False)
    rs = np.random.RandomState(seed)
    o, d = _rays(rs, N)
    t_max = rs.uniform(0, 500, N).astype(np.float32)
    t_max[::97] = 0.0
    seeds = rs.randint(0, 2 ** 32, N, dtype=np.uint64)
    u_ch, u_d = (rs.rand(N).astype(np.float32) for _ in range(2))
    jr = {k: jnp.broadcast_to(v[0], (N,) + v.shape[1:]) for k, v in jrows.items()}
    tr = {k: v[0].expand((N,) + tuple(v.shape[1:])) for k, v in trows.items()}
    J = (jr, g["jctx"], jswl, jnp.asarray(t_max), jnp.asarray(u_ch), jnp.asarray(u_d),
         jnp.asarray(o), jnp.asarray(d), jnp.asarray(seeds.astype(np.uint32)))
    T = (tr, g["tc"], tswl, torch.as_tensor(t_max), torch.as_tensor(u_ch),
         torch.as_tensor(u_d), torch.as_tensor(o), torch.as_tensor(d),
         torch.as_tensor(seeds.astype(np.int64)))
    return J, T


def _agree(got, want, what, flags_got=None, flags_want=None):
    """Values within rtol 1e-4: on every lane whose flags agree, the flags
    equal on at least 99.9% of lanes; without flags, on 99.9% of lanes."""
    n = got.shape[0]
    same = np.ones(n, bool) if flags_got is None else flags_got == flags_want
    assert same.mean() >= 0.999, (what, same.mean())
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).reshape(n, -1).all(-1)
    if flags_got is None:
        assert close.mean() >= 0.999, (what, close.mean())
    else:
        assert close[same].all(), (what, close[same].mean())


def test_grid_tracking_matches_reference():
    J, T = _loop_inputs(17)
    jtr = np.asarray(jmg.GridMedium.transmittance(J[0], J[1], J[2], J[3], *J[6:]))
    ttr = tmg.GridMedium.transmittance(T[0], T[1], T[2], T[3], *T[6:]).numpy()
    _agree(ttr, jtr, "transmittance")
    assert (jtr < 0.999).mean() > 0.2  # the rays cross the fog
    j = jmg.GridMedium.sample_distance(*J)
    t = tmg.GridMedium.sample_distance(*T)
    js, ts = np.asarray(j["scattered"]), t["scattered"].numpy()
    assert 0.05 < js.mean() < 0.95
    _agree(t["t"].numpy(), np.asarray(j["t"]), "t", ts, js)
    _agree(t["weight"].numpy(), np.asarray(j["weight"]), "weight", ts, js)
    np.testing.assert_array_equal(t["g"].numpy(), np.asarray(j["g"]))


def test_tracking_reads_the_host_every_few_steps():
    """The loops read their alive flag every CHECK_EVERY steps, never past
    MAX_TRACKING_STEPS; a lane that is done stays as it was."""
    _, T = _loop_inputs(19)
    reads0 = tmb.host_reads
    tmg.GridMedium.transmittance(T[0], T[1], T[2], T[3], *T[6:])
    reads = tmb.host_reads - reads0
    assert 1 <= reads <= tmg.MAX_TRACKING_STEPS // tmg.CHECK_EVERY + 1
    # a batch of one dead lane reads once and changes nothing
    dead = list(T)
    dead[3] = torch.zeros_like(T[3])
    out = tmg.GridMedium.sample_distance(*dead)
    assert not out["scattered"].any() and (out["t"] == 0).all()
    np.testing.assert_array_equal(out["weight"].numpy(), np.ones((N, 3), np.float32))


def test_dispatch_matches_reference_compute_all():
    """A homogeneous and a grid medium in one scene (the fog sphere and an
    environment medium), lanes of each, of neither and outside `lanes`."""
    d = testing.fog_grid((8, 8), 1, 4, dims=(8, 6, 5), seed=3)
    d["render"]["environment_medium"] = {"impl": "homogeneous", "prop": {
        "sigma_a": [0.001, 0.002, 0.003], "sigma_s": [0.004, 0.004, 0.004], "priority": 2}}
    jc = lr.compile_scene(lr.Scene.from_dict(d))
    jctx = jc.context(jc.arrays)
    tc = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    names = [c.__name__ for c in tc.plan.medium_types]
    assert names == [c.__name__ for c in jc.plan.medium_types] == ["GridMedium",
                                                                    "HomogeneousMedium"]
    assert tc.plan.env_medium_ref == jc.plan.env_medium_ref == (1, 0, 2.0)
    _, jswl, _, tswl = _spectra(False)
    J, T = _loop_inputs(23)
    rs = np.random.RandomState(29)
    tag = rs.randint(-1, 2, N).astype(np.int32)
    lanes = rs.rand(N) < 0.8
    idx = np.zeros(N, np.int32)
    init = {"t": J[3], "scattered": jnp.zeros(N, bool), "weight": jnp.ones((N, 3)),
            "g": jnp.zeros(N)}
    j = jmb.dispatch(jctx, jnp.asarray(tag), jnp.asarray(idx), "sample_distance", jswl,
                     *J[3:], init=init)
    tinit = {"t": T[3], "scattered": torch.zeros(N, dtype=torch.bool),
             "weight": torch.ones((N, 3)), "g": torch.zeros(N)}
    t = tmb.dispatch(tc, torch.as_tensor(tag), torch.as_tensor(idx), "sample_distance", tswl,
                     *T[3:], init=tinit, lanes=torch.as_tensor(lanes))
    js = np.asarray(j["scattered"])
    ts = t["scattered"].numpy()
    # outside `lanes`, init; inside, the reference's compute-all result
    assert not ts[~lanes].any() and (t["weight"].numpy()[~lanes] == 1).all()
    on = lanes
    same = ts[on] == js[on]
    assert same.mean() >= 0.999
    close = np.isclose(t["weight"].numpy()[on], np.asarray(j["weight"])[on], rtol=1e-4,
                       atol=1e-6).all(-1)
    assert (close | ~same).all()
    for lane_tag in (-1, 0, 1):
        assert (on & (tag == lane_tag)).sum() > 100
    jt = np.asarray(jmb.dispatch(jctx, jnp.asarray(tag), jnp.asarray(idx), "transmittance",
                                 jswl, J[3], J[6], J[7], J[8], init=jnp.ones((N, 3))))
    tt = tmb.dispatch(tc, torch.as_tensor(tag), torch.as_tensor(idx), "transmittance", tswl,
                      T[3], T[6], T[7], T[8], init=torch.ones((N, 3)),
                      lanes=torch.as_tensor(lanes)).numpy()
    assert (tt[~lanes] == 1).all()
    assert np.isclose(tt[on], jt[on], rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.999


# ---------------------------------------------------------------------------
# (f) the compiler's tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [False, True], ids=["fog", "fog_grid"])
def test_compiled_media_tables_match_reference(grid):
    d = (testing.fog_grid((8, 8), 1, 4, dims=(8, 6, 5), seed=3) if grid
         else testing.fog((8, 8), 1, 4))
    jc = lr.compile_scene(lr.Scene.from_dict(d))
    tc = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    assert tc.plan.has_media and jc.plan.has_media
    assert [c.__name__ for c in tc.plan.medium_types] == [
        c.__name__ for c in jc.plan.medium_types]
    assert tc.plan.env_medium_ref is None is jc.plan.env_medium_ref
    assert not tc.plan.fused_path and tc.plan.num_spheres == 0
    for k in ("medium_tag", "medium_index", "medium_priority", "surface_tag"):
        np.testing.assert_array_equal(tc.arrays["instances"][k].numpy(),
                                      np.asarray(jc.arrays["instances"][k]), k)
        assert tc.arrays["instances"][k].dtype == (
            torch.float32 if k == "medium_priority" else torch.int32)
    jm = jc.arrays["media"][0]
    tm = tc.arrays["media"][0]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), k)
    for k in ("density_grids", "density_grid_dims"):
        np.testing.assert_array_equal(tc.arrays[k].numpy(), np.asarray(jc.arrays[k]), k)
    # the sphere's 5,120 triangles block no shadow ray
    assert int((~tc.arrays["trace"]["cluster_tris"][:, 10, :].bool()
                & tc.arrays["trace"]["cluster_tris"][:, 9, :].bool()).sum()) == 5120
