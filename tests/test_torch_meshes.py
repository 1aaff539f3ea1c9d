"""File meshes and the null surface in the port (utils/objloader.py,
utils/plyloader.py, utils/loop_subdiv.py, shapes/impls.py ObjMesh,
surfaces/null.py) against the reference's, on small files written to a
temporary directory.

The loaders and the subdivision are the same numpy code on both sides, and
the compilers sort by the same SAH tree, so arrays compare exactly.
"""

import jax
import numpy as np
import pytest

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu.utils.loop_subdiv import loop_subdivide as jsubdiv
from luisarender_tpu.utils.objloader import load_obj as jload_obj
from luisarender_tpu.utils.plyloader import load_ply as jload_ply
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.scene.compiler import SceneCompiler
from luisarender_tpu_torch.shapes.impls import icosphere
from luisarender_tpu_torch.utils.loop_subdiv import loop_subdivide
from luisarender_tpu_torch.utils.objloader import load_obj
from luisarender_tpu_torch.utils.plyloader import load_ply

from torch_parity import require_reference_builder

OBJ = """# a quad, a triangle with negative indices, one without uvs
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0 0
f 1/1/1 2/2/1 3/3/1 4/4/1
f -5/-4/-2 -4/-3/-2 -1/-1/-2
f 2//1 3//1 5//1
"""


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


def test_obj_loader_matches_reference(tmp_path):
    path = tmp_path / "m.obj"
    path.write_text(OBJ)
    got = load_obj(str(path))
    _same(got, jload_obj(str(path)))
    p, t, n, uv = got
    assert t.shape == (4, 3) and p.shape[0] == 10 and n is not None and uv is not None


def _write_ply(path, fmt, faces):
    """Vertices with x y z, normals, an extra property and u v; `faces`
    lists polygons (triangles and quads)."""
    rs = np.random.RandomState(3)
    nv = 6
    verts = np.concatenate([rs.rand(nv, 3), rs.randn(nv, 3), rs.rand(nv, 1),
                            rs.rand(nv, 2)], axis=1).astype(np.float32)
    header = (
        f"ply\nformat {fmt} 1.0\ncomment test mesh\nelement vertex {nv}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property float quality\nproperty float u\nproperty float v\n"
        f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if fmt == "ascii":
            for row in verts:
                f.write((" ".join(repr(float(x)) for x in row) + "\n").encode())
            for poly in faces:
                f.write((f"{len(poly)} " + " ".join(map(str, poly)) + "\n").encode())
            return
        e = "<" if fmt == "binary_little_endian" else ">"
        f.write(verts.astype(e + "f4").tobytes())
        for poly in faces:
            f.write(np.uint8(len(poly)).tobytes())
            f.write(np.asarray(poly, e + "i4").tobytes())


@pytest.mark.parametrize("fmt,faces", [
    ("ascii", [[0, 1, 2], [2, 3, 4, 5]]),
    ("binary_little_endian", [[0, 1, 2], [1, 3, 4], [3, 4, 5]]),  # uniform rows
    ("binary_big_endian", [[0, 1, 2, 3], [3, 4, 5]]),  # row by row
])
def test_ply_loader_matches_reference(tmp_path, fmt, faces):
    path = tmp_path / "m.ply"
    _write_ply(path, fmt, faces)
    got = load_ply(str(path))
    _same(got, jload_ply(str(path)))
    p, t, n, uv = got
    assert p.shape == (6, 3) and n.shape == (6, 3) and uv.shape == (6, 2)
    assert t.shape[0] == sum(len(f) - 2 for f in faces)


@pytest.mark.parametrize("levels", [1, 2])
def test_loop_subdivision_matches_reference(levels):
    """A closed mesh (an icosahedron) and an open one (its first five
    faces, with boundary vertices)."""
    p, t = icosphere(0)
    for tris in (t, t[:5]):
        got = loop_subdivide(p, tris, levels)
        _same(got, jsubdiv(p, tris, levels))
        assert got[1].shape[0] == tris.shape[0] * 4 ** levels


@pytest.fixture(scope="module")
def reference():
    return require_reference_builder()


def _compare_compiled(d):
    ref = lr.compile_scene(lr.Scene.from_dict(d))
    arrays = jax.device_get(ref.arrays)
    port, plan = SceneCompiler(lt.Scene.from_dict(d)).compile_numpy()
    for k in port["trace"]:
        np.testing.assert_array_equal(port["trace"][k], np.asarray(arrays["trace"][k]), k)
    for k in port["instances"]:
        np.testing.assert_array_equal(port["instances"][k], np.asarray(arrays["instances"][k]), k)
    for k in port["light_entries"]:
        np.testing.assert_array_equal(port["light_entries"][k],
                                      np.asarray(arrays["light_entries"][k]), k)
    np.testing.assert_array_equal(port["light_tri_rows"], np.asarray(arrays["light_tri_rows"]))
    assert plan.num_tris == ref.plan.num_tris and plan.num_lights == ref.plan.num_lights
    assert plan.fused_path == ref.plan.fused_path
    return port, plan


def test_mesh_shapes_compile_like_reference(reference, tmp_path):
    """An OBJ icosphere with uvs under flip_uv, and a PLY quad subdivided
    twice, in the Cornell box: 32 + 1,280 + 48 triangles, so the scene
    also gets cluster tables."""
    p, t = icosphere(3)
    uv = np.stack([p[:, 0] * 0.5 + 0.5, p[:, 1] * 0.5 + 0.5], -1)
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in p.tolist()]
    lines += [f"vt {a!r} {b!r}" for a, b in uv.tolist()]
    lines += [f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}" for a, b, c in t.tolist()]
    (tmp_path / "ball.obj").write_text("\n".join(lines) + "\n")
    _write_ply(tmp_path / "patch.ply", "ascii", [[0, 1, 2], [2, 3, 4, 5]])
    matte = {"impl": "matte", "prop": {}}
    d = testing.cornell_box(resolution=(8, 8), spp=1)
    d["render"]["shapes"] += [
        {"impl": "mesh", "prop": {
            "file": str(tmp_path / "ball.obj"), "flip_uv": True, "surface": matte,
            "transform": {"impl": "srt", "prop": {"scale": [60, 60, 60],
                                                  "translate": [300, 300, 300]}}}},
        {"impl": "mesh", "prop": {
            "file": str(tmp_path / "patch.ply"), "subdivision": 2, "surface": matte,
            "transform": {"impl": "srt", "prop": {"scale": [100, 100, 100],
                                                  "translate": [100, 300, 400]}}}},
    ]
    port, plan = _compare_compiled(d)
    assert plan.num_tris == 32 + 1280 + 3 * 16
    assert "cluster_nodes" in port["trace"]


def test_null_surface_compiles_like_reference(reference):
    """The Cornell light's surface made null: the light keeps blocking
    shadow rays but has no surface tag."""
    d = testing.cornell_box(resolution=(8, 8), spp=1)
    d["render"]["shapes"][-1]["prop"]["surface"] = {"impl": "null", "prop": {}}
    port, plan = _compare_compiled(d)
    inst = port["instances"]
    assert inst["surface_tag"][-1] == -1 and inst["light_tag"][-1] == 0
    assert port["trace"]["tri_opaque"].all()
