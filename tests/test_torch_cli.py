"""The port's command-line renderer (luisarender_tpu_torch/cli.py) on the
CPU: tests/test_text_sdl.py TestCLI's 16^2 Cornell file with -o and --spp,
and that file's .luisa scene with a -D override, each image equal to
render_file's of the same scene bit for bit; without `device` it renders on
the card, and so raises on a machine without one."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)
from test_text_sdl import SCENE as LUISA_SCENE

import luisarender_tpu_torch as lt
from luisarender_tpu_torch import cli, testing
from luisarender_tpu_torch.utils import imageio

ROOT = Path(__file__).resolve().parent.parent


def _cornell_file(tmp_path, spp):
    d = testing.cornell_box(resolution=(16, 16), spp=spp, depth=2)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(d))
    return path


@pytest.mark.parametrize("ext", [".exr", ".png"])
def test_cli_matches_render_file(tmp_path, capsys, ext):
    scene_file = _cornell_file(tmp_path, spp=2)
    out = tmp_path / f"cli{ext}"
    assert cli.main([str(scene_file), "-o", str(out), "--spp", "2"], device="cpu") == 0
    printed = capsys.readouterr()
    assert printed.out.split() == [str(out)]
    assert "compiled 32 tris, 8 instances" in printed.err
    assert out.exists()
    scene = lt.load_scene(str(scene_file))
    ref = lt.render(scene, device="cpu")[scene.cameras[0].file]
    if ext == ".exr":
        np.testing.assert_array_equal(imageio.load_exr(out), ref)
    else:
        # the same linear image through the same sRGB encoder and writer
        assert out.read_bytes() == imageio.png_bytes(imageio.srgb_encode(ref))


def test_cli_spp_override(tmp_path, capsys):
    """--spp overrides the file's: a file at 4 spp rendered with --spp 1
    equals render_file of the file at 1 spp."""
    out = tmp_path / "cli.exr"
    assert cli.main([str(_cornell_file(tmp_path, spp=4)), "-o", str(out), "--spp", "1"],
                    device="cpu") == 0
    scene = lt.load_scene(str(_cornell_file(tmp_path, spp=1)))
    ref = lt.render(scene, device="cpu")[scene.cameras[0].file]
    np.testing.assert_array_equal(imageio.load_exr(out), ref)


def test_cli_luisa_define(tmp_path, capsys):
    p = tmp_path / "scene.luisa"
    p.write_text(LUISA_SCENE)
    out = tmp_path / "cli.exr"
    assert cli.main([str(p), "-D", "bright=5", "-o", str(out), "-v"], device="cpu") == 0
    img = imageio.load_exr(out)
    ref = lt.render(lt.load_scene(p, macros={"bright": "5"}), device="cpu")["out.exr"]
    np.testing.assert_array_equal(img, ref)
    np.testing.assert_allclose(img[0, 0], [5.0, 1.0, 1.0], rtol=1e-3)


def test_cli_rejects_a_bad_define(tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli.main([str(_cornell_file(tmp_path, spp=1)), "-D", "bright"], device="cpu")
    assert "expected KEY=VALUE" in capsys.readouterr().err


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    out = tmp_path / "cli.exr"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([str(_cornell_file(tmp_path, spp=1)), "-o", str(out)])
    assert not out.exists()


def test_cli_runs_as_a_module():
    proc = subprocess.run([sys.executable, "-m", "luisarender_tpu_torch.cli", "--help"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--define" in proc.stdout and "--spp" in proc.stdout


@pytest.mark.parametrize("name", ["cornell.json", "materials.json"])
def test_plan_counts_match_reference(name):
    """The triangle and instance counts the command line prints, from the
    port's compiler and from the reference's tables carried across
    (convert.py), equal the reference's plan's (analytic spheres are
    instances without triangles)."""
    import jax

    import luisarender_tpu as lr
    from luisarender_tpu_torch import convert

    torch_parity.require_reference_builder()
    path = ROOT / "scenes" / name
    jcomp = lr.compile_scene(lr.load_scene(path))
    scene = lt.load_scene(str(path))
    own = lt.compile_scene(scene, device="cpu")
    conv = convert.convert(
        jax.device_get(jcomp.arrays),
        [c.impl_names[0] for c in jcomp.plan.surface_types],
        [c.impl_names[0] for c in jcomp.plan.light_types],
        scene, device="cpu",
    )
    for plan in (own.plan, conv.plan):
        assert (plan.num_tris, plan.num_instances) == (jcomp.plan.num_tris,
                                                       jcomp.plan.num_instances)
