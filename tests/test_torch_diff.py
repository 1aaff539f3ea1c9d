"""The port's differentiable pass (luisarender_tpu_torch/diff/render.py,
diff/optimize.py) against the reference's (luisarender_tpu/diff) on the
CPU, on testing.cornell_box at 16^2 rendered with spp 2, depth 3.

- the forward images, under the reference's image rule for two forks of
  one scene (tests/test_fused_path.py): under 2% of pixels off by more than
  1e-3 and the means within 0.5% (the two do not round alike: XLA
  contracts multiply-adds, and a path whose choice flips on a rounding
  difference diverges);
- d mean(img) / d the constant-texture table, port against jax.grad of the
  reference (its pass jitted once, with remat off: the same gradient, half
  the compile): each entry within 1% relative or 1e-5 absolute;
- the reference's own three gradient tests (tests/test_diff.py) run on the
  port: finite and non-negative on the walls' rgb; the finite-difference
  check with its rule max(0.15 |fd|, 2e-4); emission linearity to rtol
  1e-3;
- remat (torch.utils.checkpoint) against no remat, and the reference's
  tables carried across by convert.py against the port's compile: equal
  gradients;
- the atlas gradient (the gather's scatter-add): on
  testing.cornell_textured at 16^2, 2 spp, depth 3 through the whole pass,
  the port under both settings of LR_TEX_GRAD_FULLMIP against the
  reference (whose pass carries no ray cone, as the port's does not, so
  both read the base level and neither reads the setting: the reference is
  jitted once), and at the image lookup with ray-cone footprints, where
  the coarser mip level passes no gradient unless LR_TEX_GRAD_FULLMIP=1:
  port against reference under both settings, within 1% or 1e-5;
- each trace wrapper on its plain version: a ray origin that requires grad
  gets no gradient through t, and the outputs are those of the call under
  no_grad bit for bit;
- recover for 3 steps from the reference test's grey start (depth 3, lr
  8e-2, bounds (0, 32), against the port's 4-spp render of the true table;
  spp 2 where the reference test takes 4, to halve the reference's
  compile): parameters and losses against the reference's
  recover(steps=3) (its pass's remat off) within 1% or 1e-5. The 48-step
  recovery at the reference test's settings runs on the card
  (chip_smoke.py phase diff, and a gpu test).
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu import testing as jtesting
from luisarender_tpu.core.types import Interaction as JInteraction
from luisarender_tpu.diff import optimize as joptimize
from luisarender_tpu.diff.render import get_in as jget_in
from luisarender_tpu.diff.render import make_render_fn as jmake_render_fn
from luisarender_tpu.textures.image import ImageTexture as JImage
from luisarender_tpu_torch import convert, testing
from luisarender_tpu_torch.core.types import Interaction as TInteraction
from luisarender_tpu_torch.diff.optimize import recover
from luisarender_tpu_torch.diff.render import get_in, make_render_fn
from luisarender_tpu_torch.ops import brute, cluster, subpacket, wide8
from luisarender_tpu_torch.textures.image import ImageTexture as TImage

from torch_parity import cluster_case, require_reference_builder, soup_rays, to_torch

ALBEDO_PATH = ("textures", "constant", "value")
ATLAS_PATH = ("texture_atlas",)
SPP, DEPTH = 2, 3


def _gap_ok(got, want):
    """(each entry within 1% relative or 1e-5 absolute, the largest gap)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    gap = np.abs(got - want)
    return bool(np.all((gap <= 0.01 * np.abs(want)) | (gap <= 1e-5))), float(gap.max())


def _frac_off(a, b):
    return float((np.abs(a - b).max(-1) > 1e-3).mean())


def _scenes(d):
    require_reference_builder()
    jscene, tscene = lr.Scene.from_dict(d), lt.Scene.from_dict(d)
    return jscene, lr.compile_scene(jscene), tscene, lt.compile_scene(tscene, device="cpu")


def _reference_pass(jscene, jcomp, path):
    """The reference's image and d mean(img) / d path, jitted once."""
    render = jmake_render_fn(jcomp, jscene.cameras[0], jscene.integrator, spp=SPP,
                             max_depth=DEPTH, remat=False)

    def mean(v):
        img = render({path: v}, jcomp.arrays)
        return jnp.mean(img), img

    (_, img), g = jax.jit(jax.value_and_grad(mean, has_aux=True))(jget_in(jcomp.arrays, path))
    return np.asarray(img), np.asarray(g)


def _port_pass(tscene, tcomp, path, remat=True):
    """The port's image and d mean(img) / d path."""
    render = make_render_fn(tcomp, tscene.cameras[0], tscene.integrator, spp=SPP,
                            max_depth=DEPTH, remat=remat)
    v = get_in(tcomp.arrays, path).clone().requires_grad_(True)
    img = render({path: v}, tcomp.arrays)
    img.mean().backward()
    return img.detach().numpy(), v.grad.numpy()


@pytest.fixture(scope="module")
def cornell():
    return _scenes(jtesting.cornell_box(resolution=(16, 16), spp=4, depth=3))


@pytest.fixture(scope="module")
def passes(cornell):
    jscene, jcomp, tscene, tcomp = cornell
    np.testing.assert_array_equal(get_in(tcomp.arrays, ALBEDO_PATH).numpy(),
                                  np.asarray(jget_in(jcomp.arrays, ALBEDO_PATH)))
    return _reference_pass(jscene, jcomp, ALBEDO_PATH), _port_pass(tscene, tcomp, ALBEDO_PATH)


@pytest.fixture(scope="module")
def port_render(cornell):
    _, _, tscene, tcomp = cornell
    render = make_render_fn(tcomp, tscene.cameras[0], tscene.integrator, spp=SPP,
                            max_depth=DEPTH)
    return render, tcomp, get_in(tcomp.arrays, ALBEDO_PATH)


def test_forward_image_matches_reference(passes):
    (ref_img, _), (img, _) = passes
    assert img.shape == ref_img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert _frac_off(img, ref_img) < 0.02
    assert abs(img.mean() / ref_img.mean() - 1.0) < 0.005


def test_grad_matches_reference(passes):
    (_, ref_g), (_, g) = passes
    ok, gap = _gap_ok(g, ref_g)
    assert ok, gap
    assert np.abs(ref_g).max() > 1e-4


def test_grad_nonzero_and_finite(passes):
    _, (_, g) = passes
    assert np.isfinite(g).all()
    # brightening any wall albedo brightens the render
    assert (g[:, :3] >= -1e-6).all()
    assert g.max() > 1e-5


def test_grad_matches_finite_difference(port_render, passes):
    """Same sampler seeds => correlated estimates => FD ~ analytic."""
    render, tcomp, base = port_render
    _, (_, g) = passes

    def loss(v):
        with torch.no_grad():
            return float(render({ALBEDO_PATH: v}, tcomp.arrays).mean())

    eps = 1e-3
    # the white wall's red channel and the red wall's red channel
    for idx in [(0, 0), (1, 0)]:
        up, down = base.clone(), base.clone()
        up[idx] += eps
        down[idx] -= eps
        fd = (loss(up) - loss(down)) / (2 * eps)
        assert abs(fd - g[idx]) <= max(0.15 * abs(fd), 2e-4), (idx, fd, g[idx])


def test_emission_gradient(port_render):
    """d(image)/d(emission scale) is exactly linear: grad == image sum."""
    render, tcomp, base = port_render
    emis_row = int(torch.argmax(base[:, :3].amax(dim=1)))
    assert float(base[emis_row].max()) > 1.0
    scale = torch.ones((), requires_grad=True)
    v = torch.cat([base[:emis_row], base[emis_row:emis_row + 1] * scale, base[emis_row + 1:]])
    total = render({ALBEDO_PATH: v}, tcomp.arrays).sum()
    total.backward()
    np.testing.assert_allclose(float(scale.grad), float(total.detach()), rtol=1e-3)


def test_remat_matches_no_remat(cornell, passes):
    _, _, tscene, tcomp = cornell
    _, (img, g) = passes
    img_n, g_n = _port_pass(tscene, tcomp, ALBEDO_PATH, remat=False)
    np.testing.assert_array_equal(img_n, img)
    np.testing.assert_array_equal(g_n, g)


def test_converted_scene_gives_the_same_gradient(cornell, passes):
    """The reference's tables carried across (convert.py, their `__src`
    columns as the scene's hoisting sources) differentiate as the port's
    own compile does."""
    jscene, jcomp, tscene, _ = cornell
    names = ([c.impl_names[0] for c in jcomp.plan.surface_types],
             [c.impl_names[0] for c in jcomp.plan.light_types])
    conv = convert.convert(jax.device_get(jcomp.arrays), *names, tscene, device="cpu")
    _, (img, g) = passes
    img_c, g_c = _port_pass(tscene, conv, ALBEDO_PATH)
    np.testing.assert_array_equal(img_c, img)
    np.testing.assert_array_equal(g_c, g)


@pytest.fixture(scope="module")
def textured():
    return _scenes(testing.cornell_textured(resolution=(16, 16), spp=SPP, depth=DEPTH))


@pytest.fixture(scope="module")
def textured_reference(textured):
    jscene, jcomp, _, _ = textured
    return _reference_pass(jscene, jcomp, ATLAS_PATH)


@pytest.mark.parametrize("fullmip", [False, True], ids=["finer_level", "fullmip"])
def test_atlas_grad_matches_reference(textured, textured_reference, fullmip, monkeypatch):
    if fullmip:
        monkeypatch.setenv("LR_TEX_GRAD_FULLMIP", "1")
    _, _, tscene, tcomp = textured
    ref_img, ref_g = textured_reference
    img, g = _port_pass(tscene, tcomp, ATLAS_PATH)
    assert _frac_off(img, ref_img) < 0.02
    ok, gap = _gap_ok(g, ref_g)
    assert ok, gap
    # the whole gradient, channel by channel, within 1%
    np.testing.assert_allclose(g.sum(axis=(0, 1)), ref_g.sum(axis=(0, 1)), rtol=0.01)
    assert ref_g[..., :3].sum() > 1e-3


def _interactions(n, seed):
    """Seeded hits with ray-cone footprints, as the reference's and the
    port's Interaction."""
    rs = np.random.default_rng(seed)
    p = rs.normal(0.0, 3.0, (n, 3)).astype(np.float32)
    uv = rs.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    foot = (10.0 ** rs.uniform(-3.0, -0.5, n)).astype(np.float32)
    zeros = np.zeros((n, 3), np.float32)
    fields = dict(p=p, ng=zeros, ns=zeros, tangent=zeros, uv=uv, footprint=foot)
    j = JInteraction(valid=jnp.ones(n, bool), inst=jnp.zeros(n, jnp.int32),
                     prim=jnp.zeros(n, jnp.int32), prim_area=jnp.ones(n),
                     back_facing=jnp.zeros(n, bool),
                     **{k: jnp.asarray(v) for k, v in fields.items()})
    t = TInteraction(valid=torch.ones(n, dtype=torch.bool), inst=torch.zeros(n, dtype=torch.int32),
                     prim=torch.zeros(n, dtype=torch.int32), prim_area=torch.ones(n),
                     back_facing=torch.zeros(n, dtype=torch.bool),
                     **{k: torch.as_tensor(v) for k, v in fields.items()})
    return j, t


@pytest.mark.parametrize("fullmip", [False, True], ids=["finer_level", "fullmip"])
def test_atlas_lookup_grad_cuts_the_coarser_level(textured, fullmip, monkeypatch):
    """The image lookup with ray-cone footprints (two mip levels blended):
    d sum(w * texel) / d atlas, port against jax.grad of the reference's
    evaluate_rows (eager, as tests/test_torch_images.py runs it)."""
    if fullmip:
        monkeypatch.setenv("LR_TEX_GRAD_FULLMIP", "1")
    _, jcomp, _, tcomp = textured
    n = 4096
    jit, tit = _interactions(n, seed=41)
    rows = tcomp.arrays["textures"]["image"]["image_id"].shape[0]
    index = np.random.default_rng(42).integers(0, rows, n).astype(np.int32)
    w = np.random.default_rng(43).uniform(0.0, 1.0, (n, 4)).astype(np.float32)
    atlas = jcomp.arrays["texture_atlas"]

    def ref_loss(a):
        arrays = {**jcomp.arrays, "texture_atlas": a}
        out = JImage.evaluate_rows(SimpleNamespace(arrays=arrays), jnp.asarray(index), jit)
        return jnp.sum(out * w)

    ref_g = np.asarray(jax.grad(ref_loss)(atlas))

    def port_grad():
        a = tcomp.arrays["texture_atlas"].clone().requires_grad_(True)
        ctx = SimpleNamespace(arrays={**tcomp.arrays, "texture_atlas": a})
        out = TImage.evaluate_rows(ctx, torch.as_tensor(index), tit)
        (out * torch.as_tensor(w)).sum().backward()
        return a.grad.numpy()

    g = port_grad()
    ok, gap = _gap_ok(g, ref_g)
    assert ok, gap
    np.testing.assert_allclose(g.sum(axis=(0, 1)), ref_g.sum(axis=(0, 1)), rtol=1e-4)
    # the other setting gives another gradient: the cut is taken
    monkeypatch.setenv("LR_TEX_GRAD_FULLMIP", "0" if fullmip else "1")
    assert np.abs(port_grad() - g).sum() > 1e-2 * np.abs(g).sum()


def _soup_tables(seed=5, n_tris=300):
    """A random soup's tables for the four trace modules."""
    pos, tris, opaque, order, _, nodes, ctris = cluster_case(n_tris, seed)
    v0, v1, v2 = (pos[tris[order, k]] for k in range(3))
    table = brute.make_tri_table(*to_torch(v0, v1 - v0, v2 - v0), torch.arange(n_tris),
                                 torch.as_tensor(opaque[order]))
    t8 = subpacket.build_bvh8(nodes)
    slab8, meta8 = subpacket.build_slab_meta(t8)
    nodes_t, ctris_t = to_torch(nodes, ctris)
    return {
        "brute": (table,),
        "cluster": (nodes_t, ctris_t),
        "wide8": (*to_torch(slab8, meta8, wide8.build_cluster_boxes(nodes)), ctris_t),
        "subpacket": (*to_torch(slab8, meta8, subpacket.build_woop_table(ctris)),),
    }


@pytest.mark.parametrize("kind", ["closest", "any_hit"])
@pytest.mark.parametrize("name", ["brute", "cluster", "wide8", "subpacket"])
def test_trace_wrapper_passes_no_gradient(name, kind):
    mod = {"brute": brute, "cluster": cluster, "wide8": wide8, "subpacket": subpacket}[name]
    entry = getattr(mod, kind)
    assert issubclass(entry.function, torch.autograd.Function)
    tables = _soup_tables()[name]
    o, d, t_min, t_max = to_torch(*soup_rays(6, 3.0, n_rays=400))
    if name == "brute":
        o, d, t_min, t_max = o[:256], d[:256], t_min[:256], t_max[:256]
    with torch.no_grad():
        plain = entry(o, d, t_min, t_max, *tables)
    og = o.clone().requires_grad_(True)
    dg = d.clone().requires_grad_(True)
    out = entry(og, dg, t_min, t_max, *tables)
    outs, plains = (out, plain) if kind == "closest" else ((out,), (plain,))
    for x, y in zip(outs, plains):
        np.testing.assert_array_equal(x.detach().numpy(), y.numpy())
    if kind == "any_hit":
        assert out.dtype == torch.bool and not out.requires_grad
        assert bool(out.any()) and not bool(out.all())
        return
    t, slot = out[0], out[1]
    assert t.requires_grad and not slot.requires_grad
    hit = torch.isfinite(t)
    assert 0 < int(hit.sum()) < t.shape[0]
    (torch.where(hit, t, 0.0).sum() + (og * 0.0).sum() + (dg * 0.0).sum()).backward()
    assert float(og.grad.abs().max()) == 0.0 and float(dg.grad.abs().max()) == 0.0


def test_recover_three_steps_matches_reference(cornell, port_render):
    jscene, jcomp, tscene, tcomp = cornell
    render, _, true_vals = port_render
    target = make_render_fn(tcomp, tscene.cameras[0], tscene.integrator, spp=4,
                            max_depth=DEPTH)
    with torch.no_grad():
        target_img = target({ALBEDO_PATH: true_vals}, tcomp.arrays).numpy()
    # the reference test's grey start: the walls at 0.5, the emission row kept
    init = true_vals.numpy().copy()
    emis_row = int(np.argmax(init[:, :3].max(axis=1)))
    for i in range(init.shape[0]):
        if i != emis_row:
            init[i, :3] = 0.5
    kw = dict(spp=SPP, max_depth=DEPTH, steps=3, learning_rate=8e-2, param_bounds=(0.0, 32.0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(joptimize, "make_render_fn", functools.partial(jmake_render_fn, remat=False))
        jparams, jlosses = joptimize.recover(jcomp, jscene.cameras[0], jscene.integrator,
                                             target_img, {ALBEDO_PATH: init}, **kw)
    params, losses = recover(tcomp, tscene.cameras[0], tscene.integrator, target_img,
                             convert.params_to_device({ALBEDO_PATH: init}, "cpu"), **kw)
    assert len(losses) == len(jlosses) == 3 and losses[-1] < losses[0]
    ok, gap = _gap_ok(losses, jlosses)
    assert ok, gap
    ok, gap = _gap_ok(params[ALBEDO_PATH].numpy(), np.asarray(jparams[ALBEDO_PATH]))
    assert ok, gap
