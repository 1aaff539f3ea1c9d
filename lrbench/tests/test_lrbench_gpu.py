"""On the card, at each cell's own size: the control (the reference in
bfloat16 in the program's place) fails the limits of `correct` on three
seeds, each planted fault fails them, and a sound short run of the
program passes them.

    python -m pytest -m gpu lrbench/tests/test_lrbench_gpu.py
"""

import pytest

from lrbench import faults, readings, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(cuda, name):
    cell = spec.cell(name)
    limits = cell.checks["limits"]
    for seed in SEEDS:
        r = readings.reading(cell, seed, 5.0, cuda, "control")
        assert any(r[k] > limits[k] for k in limits), r


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_passes_at_the_cells_size(cuda, name):
    cell = spec.cell(name)
    limits = cell.checks["limits"]
    r = readings.reading(cell, SEEDS[0], 5.0, cuda, "program")
    assert r["jobs_checked"] and all(r[k] <= limits[k] for k in limits), r


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_fails_at_the_cells_size(cuda, name, fault):
    cell = spec.cell(name)
    limits = cell.checks["limits"]
    r = readings.reading(cell, SEEDS[1], 5.0, cuda, "fault", fault)
    assert any(r[k] > limits[k] for k in limits), r
