"""The benchmark's own tests: `python -m pytest lrbench/tests` from the
repository's root. Tests that need a CUDA card carry the `gpu` marker and
skip, inside the test, where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test where none is present")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_cell(name, resolution, spp):
    """A cell of BENCHMARK.json cut to a size the CPU renders in a second:
    its traffic's resolution and samples, every pixel checked on two
    jobs."""
    from lrbench import spec

    cell = spec.cell(name)
    w, h = resolution
    return cell._replace(traffic=dict(cell.traffic, resolution=list(resolution), spp=spp),
                         checks=dict(cell.checks, pixels=w * h, jobs=2))


SMALL = {
    "cornell.final_1024": dict(resolution=(16, 16), spp=4),
}
