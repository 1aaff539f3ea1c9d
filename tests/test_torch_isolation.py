"""The port stands alone: no module of luisarender_tpu_torch, and none of
the scripts that drive it on the card (chip_smoke.py and the A/B scripts),
imports JAX, optax or anything of the JAX package, nor Pillow (the card's machine
has none: the port decodes PNG itself); importing and
rendering with it loads neither; its entry points default to the CUDA card
and raise where there is none."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "luisarender_tpu", "PIL", "optax")


# the reference's tools (luisarender_tpu/tools/), each with its port
TOOLS = tuple(f"tools/{n}.py" for n in (
    "__init__", "akr2obj", "disney2scene", "glslpt2scene", "gltf2scene", "hdr2srgb",
    "image_channels", "lux2scene", "mitsuba2scene", "obj2scene", "obj_analyse",
    "seq2video", "split_obj", "tonemap", "tungsten2scene"))
# the reference's modules without a port module: the five Pallas kernel
# files (ported as csrc/*.cu) and two MXU workarounds (ROADMAP Queue 3)
KERNEL_ONLY = ("core/fetch.py", "ops/brute_pallas.py", "ops/cluster_pallas.py",
               "ops/onehot_scatter.py", "ops/subpacket_pallas.py", "ops/trace_pallas.py",
               "ops/wide8_pallas.py")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    files = sorted((ROOT / "luisarender_tpu_torch").rglob("*.py"))
    files += [ROOT / name for name in ("chip_smoke.py", "brute_ab.py", "cluster_ab.py",
                                       "fused_ab.py", "subpacket_ab.py", "trace_ab.py",
                                       "wide8_ab.py")]
    return files


def test_no_module_imports_jax_or_the_reference():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names if _forbidden(n)]
    assert len(_port_files()) > 20
    # the hero spectrum's modules keep their own copies of the reference's
    # numpy-only CIE fits and RGB-to-spectrum solver
    scanned = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for name in ("core/cie.py", "core/rgb2spec.py", "core/spectrum.py", "spectra/hero.py",
                 "core/medium_tracker.py", "media/base.py", "media/grid.py",
                 "phasefunctions/hg.py", "integrators/mega_vpt.py", "integrators/aux.py",
                 "integrators/megapm.py", "integrators/pssmlt.py", "integrators/gpt.py",
                 "diff/render.py", "diff/optimize.py", "parallel/render.py", "ops/nograd.py"):
        assert f"luisarender_tpu_torch/{name}" in scanned, name
    # the command line, the tools and the IES parser: every module of the
    # reference's but its Pallas kernels and its MXU workarounds
    for name in ("cli.py", "utils/ies.py", *TOOLS):
        assert f"luisarender_tpu_torch/{name}" in scanned, name
    ref = {p.relative_to(ROOT / "luisarender_tpu").as_posix()
           for p in (ROOT / "luisarender_tpu").rglob("*.py")}
    port = {p.relative_to(ROOT / "luisarender_tpu_torch").as_posix()
            for p in (ROOT / "luisarender_tpu_torch").rglob("*.py")}
    assert sorted(ref - port) == sorted(KERNEL_ONLY), sorted(ref - port)
    assert not bad, bad


_PROBE = """
import sys
import luisarender_tpu_torch as lt
from luisarender_tpu_torch import testing
scene = lt.Scene.from_dict(testing.cornell_box(resolution=(8, 8), spp=1, depth=2))
img = lt.render(scene, device="cpu")["cornell.exr"]
assert img.shape == (8, 8, 3) and img.mean() > 0
# image textures: the port's own PNG decoder
scene = lt.Scene.from_dict(testing.cornell_textured(resolution=(8, 8), spp=1, depth=2))
assert lt.render(scene, device="cpu")["cornell.exr"].mean() > 0
# the differentiable pass, inverse rendering and the sharded pass
import luisarender_tpu_torch.diff.optimize, luisarender_tpu_torch.parallel.render
# the command line, every tool and the IES parser
import importlib, pkgutil, luisarender_tpu_torch.cli, luisarender_tpu_torch.utils.ies
import luisarender_tpu_torch.tools as tools
for m in pkgutil.iter_modules(tools.__path__):
    importlib.import_module("luisarender_tpu_torch.tools." + m.name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "luisarender_tpu", "PIL", "optax"))
print("LOADED", loaded)
"""


def test_import_and_render_load_neither_jax_nor_the_reference():
    """Nor Pillow, on a scene with image textures."""
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_entry_points_default_to_the_card():
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch import testing

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    scene = lt.Scene.from_dict(testing.cornell_box(resolution=(8, 8), spp=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.render(scene)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.compile_scene(scene)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.render_file(str(ROOT / "scenes" / "cornell.json"), save=False)
    import luisarender_tpu_torch.cli
    from luisarender_tpu_torch.tools import tonemap

    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.cli.main([str(ROOT / "scenes" / "cornell.json"), "-o", "unused.exr"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tonemap.tonemap_image(np.ones((2, 2, 3), np.float32))
