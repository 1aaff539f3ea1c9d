"""The port's binned-SAH builder (luisarender_tpu_torch/accel/native.py,
csrc/bvh_builder.cpp) against the reference's
(luisarender_tpu/accel/native.py build_bvh_sah).

Both are the same C++ code built by g++ with the same flags on this
machine, so every output array must be equal: no tolerance.
"""

import jax
import numpy as np
import pytest

import luisarender_tpu as lr
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.accel import native

from torch_parity import require_reference_builder, soup

FIELDS = ("aabb_min", "aabb_max", "skip", "node_first", "node_count", "prim_index",
          "leaf_size")


@pytest.fixture(scope="module")
def reference():
    return require_reference_builder()


@pytest.fixture(scope="module")
def inputs(reference):
    ref = lr.compile_scene(lr.Scene.from_dict(testing.cornell_sphere(resolution=(8, 8))))
    arrays = jax.device_get(ref.arrays)
    assert arrays["triangles"].shape[0] == 1312
    return {"soup": soup(2000), "cornell_sphere": (arrays["vertex_p"], arrays["triangles"])}


@pytest.mark.parametrize("leaf_size", [4, 128, 1])
@pytest.mark.parametrize("case", ["soup", "cornell_sphere"])
def test_sah_builder_matches_reference(reference, inputs, case, leaf_size):
    positions, triangles = inputs[case]
    ref = reference.build_bvh_sah(positions, triangles, leaf_size=leaf_size)
    got = native.build_bvh_sah(positions, triangles, leaf_size=leaf_size)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)
    # a permutation of the triangles, with leaves of at most leaf_size
    assert np.array_equal(np.sort(got.prim_index), np.arange(triangles.shape[0]))
    assert got.node_count.max() <= leaf_size


def test_library_is_built_into_place(tmp_path, monkeypatch):
    """A first build writes the library under its hashed name and leaves no
    temporary file beside it."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    positions, triangles = soup(50)
    bvh = native.build_bvh_sah(positions, triangles)
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]
    assert native.library_path().parent == tmp_path
    assert np.array_equal(np.sort(bvh.prim_index), np.arange(50))


def test_builder_raises_when_gxx_fails(tmp_path, monkeypatch):
    """No fallback tree: a failed build raises and leaves nothing behind."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "GXX_FLAGS", ("-O3", "--no-such-flag", "-shared", "-fPIC"))
    with pytest.raises(RuntimeError, match="g..? failed"):
        native.build_bvh_sah(*soup(10))
    assert list(tmp_path.iterdir()) == []


def test_builder_raises_on_refused_input():
    with pytest.raises(ValueError, match="refused"):
        native.build_bvh_sah(*soup(10), leaf_size=0)
