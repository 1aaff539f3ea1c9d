"""The port's surfaces (luisarender_tpu_torch/surfaces) against the JAX
package's, on the CPU.

(a) closures: each surface's `evaluate` and `sample` in the two packages on
    the same 4,096 seeded (wo, wi, u) and shading frames, rtol 1e-5 /
    atol 1e-6. `evaluate` is held so on every lane. `sample` draws its
    direction through sin / cos, which XLA and PyTorch round differently
    in the last place (a third of the lanes), and near the peak of a GGX
    lobe (smooth glass has alpha 1e-4) f and pdf move by far more than
    that; so its direction is held within 1e-5, its event and eta exactly
    and to rtol, and its f and pdf to rtol 1e-5 / atol 1e-6 on all but 2%
    of the lanes, the repo's rule for such flips.
(b) the general fork (integrators/mega_path.py general_path_trace_batch)
    of a Cornell box whose every surface is of the type, against the JAX
    package's bounce loop at 16^2, depth 3, 1 spp, with the reference's rule
    for its fused kernel against that loop (tests/test_fused_path.py): ray
    counts within 4, under 2% of pixels off by more than 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu import testing as jtesting
from luisarender_tpu.core.types import Interaction as JInteraction
from luisarender_tpu.integrators.mega_path import path_trace_batch as jax_ptb
from luisarender_tpu.ops import fused_path as jfused
from luisarender_tpu_torch.core.types import Interaction as TInteraction
from luisarender_tpu_torch.integrators.mega_path import general_path_trace_batch

N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _const(v):
    return {"impl": "constant", "prop": {"v": v}}


SURFACES = {
    "mirror": {"impl": "mirror", "prop": {"roughness": _const([0.2])}},
    "metal": {"impl": "metal", "prop": {"eta": "Au", "roughness": _const([0.3])}},
    "plastic": {"impl": "plastic", "prop": {"Kd": _const([0.2, 0.3, 0.8]),
                                            "roughness": _const([0.1])}},
    "glass": {"impl": "glass", "prop": {"material": "bk7"}},
    "disney": {"impl": "disney", "prop": {"color": _const([0.9, 0.5, 0.3]),
                                          "metallic": _const([0.8]),
                                          "roughness": _const([0.25]),
                                          "clearcoat": _const([0.5]),
                                          "sheen": _const([0.3])}},
    "disney_transmissive": {"impl": "disney", "prop": {
        "color": _const([0.7, 0.8, 0.9]), "roughness": _const([0.3]),
        "specular_trans": _const([0.6]), "eta": _const([1.45])}},
}


def _quad_scene(surface):
    return {"render": {
        "cameras": [{"impl": "pinhole", "prop": {
            "film": {"impl": "color", "prop": {"resolution": [4, 4]}},
            "transform": {"impl": "view", "prop": {"origin": [0, 0, 1], "front": [0, 0, -1]}},
            "spp": 1}}],
        "integrator": {"impl": "megapath", "prop": {}},
        "shapes": [{"impl": "inlinemesh", "prop": {
            "positions": [-1, -1, 0, 1, -1, 0, 1, 1, 0, -1, 1, 0],
            "indices": [0, 1, 2, 0, 2, 3], "surface": surface}}],
    }}


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(seed):
    """Shading frames with the shading normal tilted off the geometric one,
    and (wo, wi, u_lobe, u)."""
    rs = np.random.RandomState(seed)
    ng = _unit(rs, N)
    ns = ng + 0.2 * _unit(rs, N)
    ns = (ns / np.linalg.norm(ns, axis=-1, keepdims=True)).astype(np.float32)
    return {
        "ng": ng, "ns": ns, "tangent": _unit(rs, N),
        "wo": _unit(rs, N), "wi": _unit(rs, N),
        "u_lobe": rs.rand(N).astype(np.float32), "u": rs.rand(N, 2).astype(np.float32),
    }


def _interaction(cls, mod, x, **kw):
    z = mod(np.zeros((N, 3), np.float32))
    return cls(
        valid=mod(np.ones(N, bool)), inst=mod(np.zeros(N, np.int32)),
        prim=mod(np.zeros(N, np.int32)), p=z, ng=mod(x["ng"]), ns=mod(x["ns"]),
        tangent=mod(x["tangent"]), uv=mod(np.full((N, 2), 0.5, np.float32)),
        prim_area=mod(np.ones(N, np.float32)), back_facing=mod(np.zeros(N, bool)), **kw,
    )


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("name", list(SURFACES))
def test_closures_match_reference(name):
    d = _quad_scene(SURFACES[name])
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    ctx = jcomp.context()
    jcls = jcomp.plan.surface_types[0]
    jparams = {k: v[jnp.zeros(N, jnp.int32)] for k, v in ctx.arrays["surfaces"][0].items()}
    tcomp = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    tcls = tcomp.plan.surface_types[0]
    assert tcls.impl_names[0] == jcls.impl_names[0]
    tparams = {k: v[torch.zeros(N, dtype=torch.int64)]
               for k, v in tcomp.arrays["surfaces"][0].items()}

    x = _inputs(11)
    jit = _interaction(JInteraction, jnp.asarray, x)
    tit = _interaction(TInteraction, torch.as_tensor, x)
    jswl = jcomp.spectrum.sample_wavelengths(jnp.zeros((N, 1), jnp.float32))
    tswl = tcomp.spectrum.sample_wavelengths(torch.zeros((N, 1)))
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: torch.as_tensor(v) for k, v in x.items()}

    je = jcls.evaluate(jparams, ctx, jit, jswl, J["wo"], J["wi"])
    te = tcls.evaluate(tparams, tcomp, tit, tswl, T["wo"], T["wi"])
    _close(te["f"], je["f"], "evaluate f")
    _close(te["pdf"], je["pdf"], "evaluate pdf")
    assert float((je["pdf"] > 0).mean()) > 0.05  # the lobes were reached

    js = jcls.sample(jparams, ctx, jit, jswl, J["wo"], J["u_lobe"], J["u"])
    ts = tcls.sample(tparams, tcomp, tit, tswl, T["wo"], T["u_lobe"], T["u"])
    np.testing.assert_allclose(ts["wi"].numpy(), np.asarray(js["wi"]), atol=1e-5)
    np.testing.assert_array_equal(ts["event"].numpy(), np.asarray(js["event"]))
    _close(ts["eta"], js["eta"], "sample eta")
    f_ok = np.isclose(ts["f"].numpy(), np.asarray(js["f"]), rtol=RTOL, atol=ATOL).all(-1)
    pdf_ok = np.isclose(ts["pdf"].numpy(), np.asarray(js["pdf"]), rtol=RTOL, atol=ATOL)
    assert (~(f_ok & pdf_ok)).mean() < 0.02
    assert float((js["pdf"] > 0).mean()) > 0.3


def _pixels(res):
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)


@pytest.mark.parametrize("name", list(SURFACES))
def test_general_fork_matches_reference(name):
    res, depth = 16, 3
    d = jtesting.cornell_box(resolution=(res, res), spp=1, depth=depth)
    for shape in d["render"]["shapes"]:
        shape["prop"]["surface"] = SURFACES[name]
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    integ = jscene.integrator
    assert not jfused.use_fused(jcomp, integ.sampler, integ.light_sampler)
    pxy = _pixels(res)
    rgb_ref, _, st_ref = jax_ptb(
        jcomp, jcomp.arrays, jscene.cameras[0], integ.sampler, integ.light_sampler,
        jnp.asarray(pxy), jnp.int32(0), max_depth=depth, rr_depth=0,
        rr_threshold=0.95, with_stats=True,
    )
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    assert tcomp.plan.fused_path == jcomp.plan.fused_path
    rgb, _, st = general_path_trace_batch(
        tcomp, tscene.cameras[0], tscene.integrator.sampler,
        tscene.integrator.light_sampler, torch.as_tensor(pxy), 0,
        max_depth=depth, rr_depth=0, rr_threshold=0.95,
    )
    assert abs(int(st["rays"]) - int(st_ref["rays"])) <= 4
    frac = float((np.abs(rgb.numpy() - np.asarray(rgb_ref)).max(-1) > 1e-3).mean())
    assert frac < 0.02, frac
    assert np.asarray(rgb_ref).mean() > 0.0
