"""The port's scene system (luisarender_tpu_torch/scene/text_parser.py, the
stack and lerp transforms, the camera's shutter, the integrator's shutter
buckets and checkpoints, glass with a varying eta texture) against the JAX
package's, on the CPU.

(a) the text SDL: scenes/cornell.luisa, and the inputs of the reference's
    tests/test_text_sdl.py (macros and their overrides, `import`, base
    inheritance, a syntax error), parsed node for node as the reference
    parses them (tag, impl, base, every property, internal nodes in full,
    global ones by name); cornell.luisa describes what cornell.json does.
(b) stack and lerp matrices at times before, inside and after the
    keyframes, exactly; `is_static`; the camera's shutter_weights; the
    in-kernel camera's matrix at a shutter time (camgen_params' time is
    not its seed).
(c) checkpoints: a render interrupted after 4 of 8 spp and resumed, and a
    resume from the checkpoint the reference's tests/test_checkpoint.py
    builds, give the uninterrupted image bit for bit; a checkpoint of
    another spp is ignored.
(d) glass whose eta is a checkerboard of 1.3 / 1.7 (scenes/materials.json,
    the glass's material dropped, 8^2, 1 spp): its row is the reference's
    Cauchy (1.5, 0), its tables line up with the reference's (convert.py),
    and it renders.
(e) the motion-blur scene of the reference's tests/test_motion_blur.py
    (testing.motion_blur: 6 shutter buckets, each compiled at its time) on
    the CPU against tests/golden/motion_blur_48x16_16spp.exr (the
    reference's render): under 2% of pixels off by more than 1e-3, the
    mean within 0.5%, and the blur widens the lit columns.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu.ops import fused_path as jfused
from luisarender_tpu.scene import parser as jparser
from luisarender_tpu.scene.node import SceneNodeError as JSceneNodeError
from luisarender_tpu.utils import imageio as jio
from luisarender_tpu_torch import convert, testing
from luisarender_tpu_torch.integrators import mega_path as tmega
from luisarender_tpu_torch.ops import fused_path as tfused
from luisarender_tpu_torch.scene import compiler as tcompiler
from luisarender_tpu_torch.scene import parser as tparser
from luisarender_tpu_torch.scene.node import SceneNodeError as TSceneNodeError

import test_text_sdl
import torch_parity

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# (a) the text SDL
# ---------------------------------------------------------------------------


def _norm_value(v, nodes):
    if isinstance(v, list):
        return [_norm_value(x, nodes) for x in v]
    if hasattr(v, "impl_type"):
        if nodes.get(v.identifier) is v:
            return ("@", v.identifier)
        return _norm_node(v, nodes)
    if isinstance(v, bool) or isinstance(v, str):
        return v
    return float(v)


def _norm_node(node, nodes):
    return (node.tag.value, node.impl_type,
            None if node.base is None else node.base.identifier,
            {k: _norm_value(v, nodes) for k, v in sorted(node.properties.items())})


def _norm_desc(desc):
    """A parsed scene description as plain data: every global node and the
    root, node for node."""
    out = {name: _norm_node(n, desc.nodes) for name, n in sorted(desc.nodes.items())}
    out["<root>"] = _norm_node(desc.root, desc.nodes)
    return out


def _scene_file(tmp_path, case):
    if case == "cornell":
        return ROOT / "scenes" / "cornell.luisa", None
    p = tmp_path / "scene.luisa"
    if case == "import":
        (tmp_path / "mat.luisa").write_text(
            'Surface red : matte { Kd : constant { v { 1, 0, 0 } } }\n')
        p.write_text(test_text_sdl.SCENE.replace("@white", "@red") + '\nimport "mat.luisa"\n')
        return p, None
    p.write_text(test_text_sdl.SCENE)
    return p, ({"bright": "5"} if case == "macros" else None)


@pytest.mark.parametrize("case", ["cornell", "defines", "macros", "import"])
def test_text_sdl_parses_like_reference(tmp_path, case):
    path, macros = _scene_file(tmp_path, case)
    ref = jparser.parse_scene_file(path, macros)
    got = tparser.parse_scene_file(path, macros)
    assert _norm_desc(got) == _norm_desc(ref)
    scene = lt.load_scene(path, macros=macros)
    if case == "cornell":
        assert len(scene.shapes) == 8 and scene.cameras[0].film.resolution == (512, 512)
    else:
        assert len(scene.shapes) == 2
        # tri2 takes its surface from base_tri through (@base_tri)
        assert scene.shapes[1].surface is scene.shapes[0].surface
    if case == "macros":
        env = got.root.properties["environment"].properties["emission"]
        assert env.properties["v"][0] == 5.0


def test_text_sdl_syntax_error_and_cornell_json(tmp_path):
    """A syntax error raises in both parsers; cornell.luisa and cornell.json
    describe the same scene: the same nodes, tags, impls and values."""
    p = tmp_path / "bad.luisa"
    p.write_text("render { cameras }")
    with pytest.raises(JSceneNodeError):
        jparser.parse_scene_file(p)
    with pytest.raises(TSceneNodeError):
        lt.load_scene(p)
    luisa = lt.load_scene(ROOT / "scenes" / "cornell.luisa")
    js = lt.load_scene(ROOT / "scenes" / "cornell.json")
    a = tcompiler.SceneCompiler(luisa).compile_numpy()
    b = tcompiler.SceneCompiler(js).compile_numpy()
    assert [c.impl_names[0] for c in a[1].surface_types] == [
        c.impl_names[0] for c in b[1].surface_types]
    np.testing.assert_array_equal(a[0]["trace"]["tri_v0"], b[0]["trace"]["tri_v0"])
    # each instance's surface and light rows (the text file shares named
    # surfaces between instances, the JSON file has one a shape)
    for key, group in (("surface", "surfaces"), ("light", "lights")):
        for i in range(len(luisa.shapes)):
            rows = []
            for tables, _ in (a, b):
                inst = tables["instances"]
                tag, idx = inst[f"{key}_tag"][i], inst[f"{key}_index"][i]
                rows.append(None if tag < 0 else {
                    k: v[idx] for k, v in tables[group][tag].items()})
            assert (rows[0] is None) == (rows[1] is None)
            if rows[0] is not None:
                assert sorted(rows[0]) == sorted(rows[1])
                for k in rows[0]:
                    np.testing.assert_allclose(rows[0][k], rows[1][k], err_msg=f"{i} {k}")
    assert a[1].fused_path and b[1].fused_path


# ---------------------------------------------------------------------------
# (b) transforms and the shutter
# ---------------------------------------------------------------------------


def _srt(t, s=1.0, angle=0.0):
    return {"impl": "srt", "prop": {"translate": t, "scale": [s, s, s],
                                    "rotate": [0.0, 1.0, 0.3, angle]}}


TRANSFORMS = {
    "stack": {"impl": "stack", "prop": {"transforms": [
        _srt([1, 2, 3], 2.0, 30.0), {"impl": "matrix", "prop": {"m": [
            1, 0.2, 0, 4, 0, 1, 0.1, 0, 0.3, 0, 1, -2, 0, 0, 0, 1]}},
        _srt([0, -1, 0], 0.5, -45.0)]}},
    "lerp": {"impl": "lerp", "prop": {"transforms": [
        _srt([0, 0, 0]), _srt([120, 0, 0], 1.5, 40.0), _srt([120, 50, 0], 1.0, 90.0)],
        "time_points": [0.0, 0.4, 1.0]}},
    "stack_of_lerp": {"impl": "stack", "prop": {"transforms": [
        _srt([5, 0, 0], 1.0, 10.0), {"impl": "lerp", "prop": {
            "transforms": [_srt([0, 0, 0]), _srt([0, 0, 9], 2.0)],
            "time_points": [0.25, 0.75]}}]}},
}


def _shape_with(transform):
    d = testing.cornell_box(resolution=(4, 4), spp=1, depth=1)
    d["render"]["shapes"][5]["prop"]["transform"] = transform
    return d


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_stack_and_lerp_matrices(name):
    d = _shape_with(TRANSFORMS[name])
    jt = lr.Scene.from_dict(d).shapes[5].transform
    tt = lt.Scene.from_dict(d).shapes[5].transform
    assert tt.is_static == jt.is_static == (name == "stack")
    for t in (-0.5, 0.0, 0.2, 0.25, 0.4, 0.5, 0.7, 1.0, 1.5):
        np.testing.assert_array_equal(tt.matrix(t), jt.matrix(t), err_msg=f"t={t}")


def test_shutter_weights_and_camera_time():
    """shutter_weights for several bucket counts and an empty span; a
    pinhole camera moving under lerp: the in-kernel camera's matrix at a
    shutter time is the reference's at that time, whatever the seed."""
    d = testing.cornell_box(resolution=(8, 8), spp=1, depth=1)
    cam = d["render"]["cameras"][0]["prop"]
    cam["shutter_span"] = [0.25, 1.5]
    view = cam["transform"]
    moved = json.loads(json.dumps(view))
    moved["prop"]["origin"] = [300.0, 280.0, -780.0]
    cam["transform"] = {"impl": "lerp", "prop": {"transforms": [view, moved],
                                                 "time_points": [0.0, 1.0]}}
    jcam, tcam = lr.Scene.from_dict(d).cameras[0], lt.Scene.from_dict(d).cameras[0]
    for n in (0, 1, 2, 6):
        np.testing.assert_array_equal(np.asarray(tcam.shutter_weights(n)),
                                      np.asarray(jcam.shutter_weights(n)))
    still = lt.Scene.from_dict(testing.cornell_box(resolution=(8, 8), spp=1)).cameras[0]
    assert still.shutter_weights(6) == ([0.0], [1.0])
    for t in (0.0, 0.3, 0.9):
        got = tfused.camgen_params(tcam, 12345, time=t)
        ref = jfused.camgen_params(jcam, t)
        assert got["sampler_seed"] == 12345
        assert {k: got[k] for k in ref} == ref


# ---------------------------------------------------------------------------
# (c) checkpoints
# ---------------------------------------------------------------------------


def _ckpt_scene(ckpt, spp=8):
    d = testing.cornell_box(resolution=(16, 16), spp=spp, depth=2)
    d["render"]["integrator"]["prop"].update(
        {"checkpoint_file": str(ckpt), "checkpoint_interval": 4, "samples_per_pass": 4})
    return lt.Scene.from_dict(d)


def test_checkpoint_resume_is_exact(tmp_path, monkeypatch):
    ckpt = tmp_path / "film.npz"
    full = lt.render(_ckpt_scene(ckpt), device="cpu")["cornell.exr"]
    data = np.load(ckpt)
    assert int(data["done"]) == 8 and int(data["spp"]) == 8

    # interrupted: the fifth sample raises after the first pass's checkpoint
    ckpt.unlink()
    orig = tmega.path_trace_batch

    def interrupted(*args, **kw):
        if args[5] == 4:
            raise KeyboardInterrupt
        return orig(*args, **kw)

    monkeypatch.setattr(tmega, "path_trace_batch", interrupted)
    with pytest.raises(KeyboardInterrupt):
        lt.render(_ckpt_scene(ckpt), device="cpu")
    monkeypatch.setattr(tmega, "path_trace_batch", orig)
    assert int(np.load(ckpt)["done"]) == 4
    scene = _ckpt_scene(ckpt)
    resumed = lt.render(scene, device="cpu")["cornell.exr"]
    np.testing.assert_array_equal(resumed, full)
    assert scene.integrator.fused_passes == 4  # the resumed render ran 4 samples

    # the reference's construction: a 4-spp render's image as the checkpoint
    half = lt.render(lt.Scene.from_dict(testing.cornell_box(
        resolution=(16, 16), spp=4, depth=2, samples_per_pass=4)), device="cpu")["cornell.exr"]
    accum = np.concatenate([half * 4.0, np.full((16, 16, 1), 4.0, np.float32)], axis=-1)
    np.savez(ckpt, accum=accum, done=4, spp=8)
    resumed = lt.render(_ckpt_scene(ckpt), device="cpu")["cornell.exr"]
    np.testing.assert_allclose(resumed, full, rtol=1e-5, atol=1e-6)


def test_mismatched_checkpoint_ignored(tmp_path):
    ckpt = tmp_path / "film.npz"
    np.savez(ckpt, accum=np.zeros((4, 4, 4), np.float32), done=2, spp=99)
    scene = _ckpt_scene(ckpt, spp=2)
    img = lt.render(scene, device="cpu")["cornell.exr"]
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert scene.integrator.fused_passes == 2 and int(np.load(ckpt)["done"]) == 2


# ---------------------------------------------------------------------------
# (d) glass with a varying eta
# ---------------------------------------------------------------------------


def _glass_eta_scene():
    with open(ROOT / "scenes" / "materials.json") as f:
        d = json.load(f)
    for shape in d["render"]["shapes"]:
        surf = shape.get("prop", {}).get("surface", {})
        if surf.get("impl") == "glass":
            surf["prop"].pop("material")
            surf["prop"]["eta"] = {"impl": "checkerboard", "prop": {
                "on": {"impl": "constant", "prop": {"v": [1.3]}},
                "off": {"impl": "constant", "prop": {"v": [1.7]}}}}
    cam = d["render"]["cameras"][0]["prop"]
    cam["film"]["prop"]["resolution"] = [8, 8]
    cam["spp"] = 1
    return d


def test_glass_varying_eta_row_matches_reference():
    torch_parity.require_reference_builder()
    d = _glass_eta_scene()
    jcomp = lr.compile_scene(lr.Scene.from_dict(d))
    tscene = lt.Scene.from_dict(d)
    tcomp = lt.compile_scene(tscene, device="cpu")
    names = [c.impl_names[0] for c in jcomp.plan.surface_types]
    assert names == [c.impl_names[0] for c in tcomp.plan.surface_types]
    g = names.index("glass")
    jrow, trow = jcomp.arrays["surfaces"][g], tcomp.arrays["surfaces"][g]
    for k in ("cauchy_a", "cauchy_b"):
        np.testing.assert_array_equal(trow[k].numpy(), np.asarray(jrow[k]))
    assert 1.5 in trow["cauchy_a"].tolist() and 0.0 in trow["cauchy_b"].tolist()
    # the eta texture is loaded and never compiled, in both packages
    assert [c.impl_names[0] for c in jcomp.plan.texture_types] == [
        c.impl_names[0] for c in tcomp.plan.texture_types]
    conv = convert.convert(jax.device_get(jcomp.arrays), names,
                           [c.impl_names[0] for c in jcomp.plan.light_types], tscene,
                           device="cpu",
                           texture_types=[c.impl_names[0] for c in jcomp.plan.texture_types])
    for tt, ct in zip(tcomp.arrays["surfaces"], conv.arrays["surfaces"]):
        assert sorted(tt) == sorted(ct)
        for k in tt:
            np.testing.assert_array_equal(tt[k].numpy(), ct[k].numpy(), err_msg=k)
    img = tscene.integrator.render(tcomp)["materials.exr"]
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0.0


# ---------------------------------------------------------------------------
# (e) motion blur
# ---------------------------------------------------------------------------


def test_motion_blur_matches_golden(monkeypatch):
    compiles = []
    orig = tcompiler.compile_scene

    def counted(scene, device=None, time=0.0):
        compiles.append(time)
        return orig(scene, device=device, time=time)

    monkeypatch.setattr(tcompiler, "compile_scene", counted)
    img = lt.render(lt.Scene.from_dict(testing.motion_blur()), device="cpu")["mb.exr"]
    np.testing.assert_allclose(compiles, np.linspace(0.0, 1.0, 6))
    ref = jio.load_exr(str(ROOT / "tests" / "golden" / "motion_blur_48x16_16spp.exr"))
    assert img.shape == ref.shape == (16, 48, 3) and np.isfinite(img).all()
    assert float((np.abs(img - ref).max(-1) > 1e-3).mean()) < 0.02
    assert abs(float(img.mean() / ref.mean()) - 1.0) < 0.005
    static = lt.render(lt.Scene.from_dict(testing.motion_blur(shutter=False)),
                       device="cpu")["mb.exr"]

    def lit_columns(a):
        return int((a.sum(axis=(0, 2)) > 0.01).sum())

    assert lit_columns(img) > 2 * lit_columns(static)
