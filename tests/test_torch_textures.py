"""The port's procedural textures and texture mappings
(luisarender_tpu_torch/textures, texturemappings) and their evaluation at
surface hits, against the JAX package, on the CPU.

Each case puts a texture on the Cornell box's floor and compiles the scene
in both packages: the handles and texture tables agree, and the texture
evaluated at the same seeded interactions (positions and uvs from numpy)
agrees with the reference's `evaluate_handles` within rtol 1e-5 / atol
1e-6 (the spherical mapping's arccos and atan2 round differently by an ulp
in XLA and PyTorch). Renders on the general fork are held by the
reference's rule (tests/test_fused_path.py:108-110).
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
from luisarender_tpu.textures import base as jtex
from luisarender_tpu_torch.core.types import Interaction as TInteraction
from luisarender_tpu_torch.integrators.mega_path import path_trace_batch, pixel_grid
from luisarender_tpu_torch.textures import base as ttex

import torch_parity  # noqa: F401  (one torch thread)


def _const(v):
    return {"impl": "constant", "prop": {"v": v}}


def _checker(mapping=None, on=None, off=None, uv_scale=(4.0, 3.0)):
    prop = {"on": on or _const([0.9, 0.3, 0.2]), "off": off or _const([0.1, 0.2, 0.7]),
            "uv_scale": list(uv_scale)}
    if mapping:
        prop["mapping"] = mapping
    return {"impl": "checkerboard", "prop": prop}


UV_MAP = {"impl": "uv", "prop": {"uv_scale": [2.0, 0.5], "uv_offset": [0.25, 0.1]}}
SPH_MAP = {"impl": "spherical", "prop": {"uv_scale": [6.0, 3.0], "uv_offset": [0.0, 0.5]}}
TEXTURES = {
    "checkerboard_uv": _checker(UV_MAP),
    "checkerboard_spherical": _checker(SPH_MAP, uv_scale=(1.0, 1.0)),
    "checkerboard_default": _checker(),
    "scale": {"impl": "scale", "prop": {"base": _checker(UV_MAP), "scale": [0.5, 2.0, 1.0]}},
    "swizzle": {"impl": "swizzle", "prop": {"base": _checker(SPH_MAP), "swizzle": "bgr"}},
    "nested": _checker(UV_MAP, on={"impl": "scale", "prop": {
        "base": _checker(SPH_MAP), "scale": [0.5]}}, off={"impl": "swizzle", "prop": {
            "base": _const([0.2, 0.4, 0.6]), "swizzle": "zyx"}}),
    "scale_of_constant": {"impl": "scale", "prop": {"base": _const([0.4, 0.5, 0.6]),
                                                    "scale": [1.5]}},
}


def _scene(tex, res=16, depth=3):
    d = jtesting.cornell_box(resolution=(res, res), spp=1, depth=depth)
    d["render"]["shapes"][0]["prop"]["surface"] = {"impl": "matte", "prop": {"Kd": tex}}
    return d


def _interactions(n, seed):
    rs = np.random.default_rng(seed)
    p = rs.uniform(-300.0, 600.0, (n, 3)).astype(np.float32)
    uv = rs.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    zeros = np.zeros((n, 3), np.float32)
    j = JInteraction(valid=jnp.ones(n, bool), inst=jnp.zeros(n, jnp.int32),
                     prim=jnp.zeros(n, jnp.int32), p=jnp.asarray(p), ng=jnp.asarray(zeros),
                     ns=jnp.asarray(zeros), tangent=jnp.asarray(zeros), uv=jnp.asarray(uv),
                     prim_area=jnp.ones(n), back_facing=jnp.zeros(n, bool))
    t = TInteraction(valid=torch.ones(n, dtype=torch.bool), inst=torch.zeros(n, dtype=torch.int32),
                     prim=torch.zeros(n, dtype=torch.int32), p=torch.as_tensor(p),
                     ng=torch.as_tensor(zeros), ns=torch.as_tensor(zeros),
                     tangent=torch.as_tensor(zeros), uv=torch.as_tensor(uv),
                     prim_area=torch.ones(n), back_facing=torch.zeros(n, dtype=torch.bool))
    return j, t


@pytest.mark.parametrize("name", list(TEXTURES))
def test_texture_evaluation_matches_reference(name):
    d = _scene(TEXTURES[name])
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    names = [c.impl_names[0] for c in tcomp.plan.texture_types]
    assert names == [c.impl_names[0] for c in jcomp.plan.texture_types]
    assert tcomp.plan.needs_uv == jcomp.plan.needs_uv
    # a floor with a varying texture leaves the fused fork, as in the reference
    assert not tcomp.plan.fused_path and not jcomp.plan.fused_path
    # the floor's texture handle, from its matte row: the same in both
    t_handles = tcomp.arrays["surfaces"][0]["kd__h"]
    handle = int(t_handles[t_handles >= 0][0])
    j_handles = np.asarray(jcomp.arrays["surfaces"][0]["kd"])
    assert handle == int(j_handles[j_handles >= 0][0])
    n = 4096
    jit, tit = _interactions(n, seed=len(name))
    ref = jtex.evaluate_handles(jcomp.context(), jnp.full((n,), handle, jnp.int32), jit)
    got = ttex.evaluate_handles(tcomp, torch.full((n,), handle, dtype=torch.int32), tit)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # both checkerboard colours show up where the texture has them
    assert len(np.unique(got.numpy()[:, 0])) >= (1 if name == "scale_of_constant" else 2)


@pytest.mark.parametrize("name", ["scale", "swizzle", "scale_of_constant"])
def test_evaluate_static_matches_reference(name):
    tex = TEXTURES[name]
    d = _scene({"impl": "scale", "prop": {"base": _const([0.3, 0.6, 0.9]), "scale": [2.0]}}
               if name == "scale" else {"impl": "swizzle", "prop": {
                   "base": _const([0.3, 0.6, 0.9]), "swizzle": "zxy"}}
               if name == "swizzle" else tex)
    j = lr.Scene.from_dict(d).shapes[0].surface.kd
    t = lt.Scene.from_dict(d).shapes[0].surface.kd
    np.testing.assert_array_equal(t.evaluate_static(), j.evaluate_static())
    assert t.channels == j.channels


def test_textured_render_matches_reference():
    """The general fork on a checkerboard floor (uv mapping), two samples,
    against the reference's path_trace_batch."""
    d = _scene(TEXTURES["checkerboard_uv"])
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    pxy = pixel_grid(16, 16, "cpu")
    kw = dict(max_depth=3, rr_depth=0, rr_threshold=0.95)
    for si in range(2):
        rgb_ref, _, st_ref = jax_ptb(
            jcomp, jcomp.arrays, jscene.cameras[0], jscene.integrator.sampler,
            jscene.integrator.light_sampler, jnp.asarray(pxy.numpy()), jnp.int32(si),
            with_stats=True, **kw)
        rgb, _, st = path_trace_batch(
            tcomp, tscene.cameras[0], tscene.integrator.sampler,
            tscene.integrator.light_sampler, pxy, si, with_stats=True, **kw)
        assert st["fused"] == 0
        assert abs(int(st["rays"]) - int(st_ref["rays"])) <= 4
        off = (np.abs(rgb.numpy() - np.asarray(rgb_ref)).max(-1) > 1e-3).mean()
        assert off < 0.02
