"""Analytic spheres in the port (shapes/impls.py SphereShape, the compiler's
sphere table, accel/traverse.py, scene/geometry.py) against the JAX
package, on the CPU.

Both sides run the same float32 formulas; the tolerance (rtol 1e-6) covers
the order XLA and PyTorch sum three-term dot products in and their acos /
atan2 / sin / cos, which neither rounds correctly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu import testing as jtesting
from luisarender_tpu.accel import traverse as jtrav
from luisarender_tpu.core import types as jtypes
from luisarender_tpu.scene.geometry import surface_interaction as jinteraction
from luisarender_tpu_torch import convert
from luisarender_tpu_torch.accel import traverse as ttrav
from luisarender_tpu_torch.core import types as ttypes
from luisarender_tpu_torch.scene.geometry import surface_interaction as tinteraction

MATERIALS = Path(__file__).parent.parent / "scenes" / "materials.json"
RTOL, ATOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def materials():
    jcomp = lr.compile_scene(lr.load_scene(str(MATERIALS)))
    tcomp = lt.compile_scene(lt.load_scene(str(MATERIALS)), device="cpu")
    return jcomp, tcomp


def test_sphere_table_and_instances_match(materials):
    jcomp, tcomp = materials
    assert tcomp.plan.num_spheres == jcomp.plan.num_spheres == 4
    assert tcomp.plan.num_tris == jcomp.plan.num_tris == 12
    np.testing.assert_allclose(
        tcomp.arrays["trace"]["sph"].numpy(), np.asarray(jcomp.arrays["trace"]["sph"]),
        rtol=RTOL, atol=1e-6,
    )
    for k in ("surface_tag", "surface_index", "light_tag", "light_index", "light_entry"):
        np.testing.assert_array_equal(tcomp.arrays["instances"][k].numpy(),
                                      np.asarray(jcomp.arrays["instances"][k]), k)
    assert [c.impl_names[0] for c in tcomp.plan.surface_types] == [
        c.impl_names[0] for c in jcomp.plan.surface_types
    ]
    # the reference's tables carried across keep the spheres
    conv, plan = convert.convert_tables(
        jax.device_get(jcomp.arrays),
        [c.impl_names[0] for c in jcomp.plan.surface_types],
        [c.impl_names[0] for c in jcomp.plan.light_types],
    )
    assert plan.num_spheres == 4 and plan.fused_path
    np.testing.assert_array_equal(conv["trace"]["sph"], np.asarray(jcomp.arrays["trace"]["sph"]))


def _rays(sph, n, seed):
    """Rays from around the spheres toward points near their centres, with
    a mix of open, clipped and empty t ranges."""
    rs = np.random.RandomState(seed)
    c = sph[:, 0:3]
    r = sph[:, 3]
    k = rs.randint(0, sph.shape[0], n)
    target = c[k] + rs.normal(size=(n, 3)) * r[k, None] * 0.8
    o = c.mean(0) + rs.normal(size=(n, 3)) * 300.0
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.zeros(n)
    t_max = np.where(rs.rand(n) < 0.2, rs.rand(n) * 400.0, np.inf)
    t_max[rs.rand(n) < 0.05] = 0.0
    return [x.astype(np.float32) for x in (o, d, t_min, t_max)]


def test_sphere_closest_any_and_interaction_match(materials):
    jcomp, tcomp = materials
    sph = np.array(jcomp.arrays["trace"]["sph"])
    o, d, t_min, t_max = _rays(sph, 4096, 3)
    jray = jtypes.Ray(*(jnp.asarray(x) for x in (o, d, t_min, t_max)))
    tray = ttypes.Ray(*(torch.as_tensor(x) for x in (o, d, t_min, t_max)))

    jt, ji, ju, jv = (np.array(x) for x in jtrav._sphere_closest(
        jnp.asarray(sph), jray, jray.t_min, jray.t_max))
    tt, ti, tu, tv = (x.numpy() for x in ttrav.sphere_closest(torch.as_tensor(sph), tray))
    np.testing.assert_array_equal(ti, ji)
    hit = ji >= 0
    assert 0.3 < hit.mean() < 0.95
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=RTOL)
    assert np.all(np.isinf(tt[~hit]))
    np.testing.assert_allclose(tu[hit], ju[hit], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tv[hit], jv[hit], rtol=RTOL, atol=ATOL)

    np.testing.assert_array_equal(
        ttrav.sphere_any(torch.as_tensor(sph), tray).numpy(),
        np.asarray(jtrav._sphere_any(jnp.asarray(sph), jray)),
    )

    # interactions at the sphere hits: prim = P + sphere index, bary = (u, v)
    p_rows = int(np.asarray(jcomp.arrays["trace"]["shade_table"]).shape[0])
    prim = np.where(hit, p_rows + ji, -1).astype(np.int32)
    bary = np.stack([ju, jv], -1)
    jit = jinteraction(jcomp.arrays, jtypes.Hit(
        inst=jnp.zeros_like(jnp.asarray(prim)), prim=jnp.asarray(prim),
        bary=jnp.asarray(bary), t=jnp.asarray(jt)), jray)
    t_prows = tcomp.arrays["trace"]["shade_table"].shape[0]
    tit = tinteraction(tcomp.arrays, ttypes.Hit(
        inst=torch.zeros(4096, dtype=torch.int32),
        prim=torch.as_tensor(np.where(hit, t_prows + ji, -1).astype(np.int32)),
        bary=torch.as_tensor(bary), t=torch.as_tensor(jt)), tray)
    np.testing.assert_array_equal(tit.valid.numpy(), np.asarray(jit.valid))
    np.testing.assert_array_equal(tit.inst.numpy(), np.asarray(jit.inst))
    for k in ("p", "ng", "ns", "tangent", "uv", "prim_area"):
        np.testing.assert_allclose(getattr(tit, k).numpy()[hit], np.asarray(getattr(jit, k))[hit],
                                   rtol=1e-5, atol=1e-4, err_msg=k)


def test_non_analytic_sphere_is_an_icosphere_mesh():
    d = jtesting.cornell_box(resolution=(16, 16), spp=1, depth=3)
    d["render"]["shapes"].append({"impl": "sphere", "prop": {
        "analytic": False, "subdivision": 2,
        "surface": {"impl": "matte", "prop": {}},
        "transform": {"impl": "srt", "prop": {"scale": [100, 100, 100],
                                              "translate": [400, 100, 300]}}}})
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    tcomp = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    assert tcomp.plan.num_tris == jcomp.plan.num_tris == 32 + 320
    assert tcomp.plan.num_spheres == jcomp.plan.num_spheres == 0
    assert not tcomp.plan.fused_path and not jcomp.plan.fused_path
    # an emissive sphere falls back to the mesh as well
    d["render"]["shapes"][-1]["prop"].update(
        analytic=True, light={"impl": "diffuse", "prop": {"emission": {
            "impl": "constant", "prop": {"v": [1.0, 1.0, 1.0]}}}})
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    tcomp = lt.compile_scene(lt.Scene.from_dict(d), device="cpu")
    assert tcomp.plan.num_tris == jcomp.plan.num_tris == 32 + 320
    assert tcomp.plan.num_spheres == 0
