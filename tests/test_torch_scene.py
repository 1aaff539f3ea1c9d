"""The port's scene compiler (luisarender_tpu_torch/scene/compiler.py) on
scenes/cornell.json against the reference's compiled tables carried across
by luisarender_tpu_torch/convert.py.

Both packages sort triangles into the order of the same binned-SAH tree
(the same builder source, built with the same flags), so per-triangle rows
compare row by row, slot for slot. Both sides run the same float32 numpy
construction, so the tolerance is float32 rounding.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu.core import sampling as jsampling
from luisarender_tpu_torch import convert
from luisarender_tpu_torch.core import sampling as tsampling
from luisarender_tpu_torch.scene.compiler import SceneCompiler

from torch_parity import require_reference_builder

CORNELL = Path(__file__).parent.parent / "scenes" / "cornell.json"
RTOL, ATOL = 1e-6, 1e-6


@pytest.fixture(scope="module")
def tables():
    require_reference_builder()
    ref = lr.compile_scene(lr.load_scene(str(CORNELL)))
    names = (
        [c.impl_names[0] for c in ref.plan.surface_types],
        [c.impl_names[0] for c in ref.plan.light_types],
    )
    conv, conv_plan = convert.convert_tables(jax.device_get(ref.arrays), *names)
    port, port_plan = SceneCompiler(lt.load_scene(str(CORNELL))).compile_numpy()
    return ref, conv, conv_plan, port, port_plan


def test_plan_matches(tables):
    ref, _, conv_plan, _, port_plan = tables
    assert port_plan == conv_plan
    assert port_plan.num_tris == ref.plan.num_tris == 32
    assert port_plan.num_lights == ref.plan.num_lights == 1
    assert [c.impl_names[0] for c in port_plan.surface_types] == ["matte"]


def test_trace_and_shade_rows_match_per_original_triangle(tables):
    """Row r is original triangle prim_index[r] on both sides: the same
    permutation, and the same rows slot by slot."""
    _, conv, _, port, _ = tables
    a, b = conv["trace"], port["trace"]
    np.testing.assert_array_equal(b["prim_index"], a["prim_index"])
    assert np.array_equal(np.sort(b["prim_index"]), np.arange(32))
    assert not np.array_equal(b["prim_index"], np.arange(32))  # sorted, not original
    for k in ("tri_v0", "tri_e1", "tri_e2", "shade_table"):
        np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(b["tri_opaque"], a["tri_opaque"])


def test_instance_light_and_alias_rows_match(tables):
    _, conv, _, port, _ = tables
    for k in conv["instances"]:
        np.testing.assert_array_equal(port["instances"][k], conv["instances"][k], k)
    for k in conv["light_entries"]:
        np.testing.assert_allclose(port["light_entries"][k],
                                   conv["light_entries"][k], rtol=RTOL, err_msg=k)
    for k in ("light_alias_prob", "light_alias_alias", "light_tri_rows"):
        np.testing.assert_allclose(port[k], conv[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_surface_and_light_parameter_rows_match(tables):
    _, conv, _, port, _ = tables
    for group in ("surfaces", "lights"):
        assert len(port[group]) == len(conv[group])
        for p_tab, c_tab in zip(port[group], conv[group]):
            assert sorted(p_tab) == sorted(c_tab)
            for k in p_tab:
                np.testing.assert_allclose(p_tab[k], c_tab[k], rtol=RTOL,
                                           err_msg=f"{group}.{k}")
    # the red wall's albedo and the light's emission made it across
    assert any(np.allclose(r, [0.63, 0.065, 0.05]) for r in port["surfaces"][0]["kd"])
    np.testing.assert_allclose(port["lights"][0]["emission"], [[17.0, 12.0, 4.0]])


def test_unsupported_plugins_raise_not_implemented():
    from luisarender_tpu_torch import testing

    d = testing.cornell_box(resolution=(8, 8), spp=1)
    d["render"]["integrator"]["impl"] = "bdpt"
    with pytest.raises(NotImplementedError, match="bdpt"):
        lt.Scene.from_dict(d)
    d = testing.cornell_box(resolution=(8, 8), spp=1)
    d["render"]["shapes"][0]["prop"]["surface"] = {"impl": "matte", "prop": {
        "Kd": {"impl": "normal_map", "prop": {"file": "floor.png"}}}}
    with pytest.raises(NotImplementedError, match="normal_map"):
        lt.Scene.from_dict(d)


def test_alias_table_build_and_sample_match():
    rs = np.random.RandomState(7)
    weights = rs.rand(37) ** 3
    ref = jsampling.build_alias_table(weights)
    got = tsampling.build_alias_table(weights)
    np.testing.assert_array_equal(got.prob, np.asarray(ref.prob))
    np.testing.assert_array_equal(got.alias, np.asarray(ref.alias))
    np.testing.assert_array_equal(got.pdf, np.asarray(ref.pdf))
    u = rs.rand(4096).astype(np.float32)
    i_r, pdf_r, u_r = jsampling.alias_sample(ref, jnp.asarray(u))
    i_t, pdf_t, u_t = tsampling.alias_sample(
        *[torch.as_tensor(x) for x in got], torch.as_tensor(u)
    )
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
    np.testing.assert_array_equal(pdf_t.numpy(), np.asarray(pdf_r))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_r), rtol=1e-6, atol=1e-7)
