"""No module of the benchmark, and none of its reference, imports JAX or
the JAX package (by whole top-level name: luisarender_tpu_torch, the
program, begins with luisarender_tpu); the reference imports nothing of
the program either; a run refuses to report with such a module loaded."""

import ast

import pytest

from lrbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "luisarender_tpu"}
SOURCES = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts)


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_module_of_the_benchmark_imports_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "luisarender_tpu_torch" not in imported_tops(path)
    assert imported_tops(path) <= {"__future__", "math", "typing", "zlib", "numpy", "torch"}


def test_the_run_checks_whole_top_level_names():
    mods = {"luisarender_tpu_torch": 0, "luisarender_tpu_torch.ops": 0, "jaxtyping": 0,
            "torch": 0}
    assert run.forbidden_modules(mods) == []
    mods.update({"luisarender_tpu.scene": 0, "jax": 0, "jax.numpy": 0, "flax.linen": 0})
    assert run.forbidden_modules(mods) == ["flax.linen", "jax", "jax.numpy",
                                           "luisarender_tpu.scene"]


def test_a_run_without_a_card_exits_non_zero(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "cornell.final_1024", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
