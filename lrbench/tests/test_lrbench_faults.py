"""`correct` on the CPU at small sizes: the references agree with the
program's own plain versions bit for bit, a sound run passes, and each
fault the cells can have, planted under the timed path, and the control
(the reference in bfloat16 in the program's place) fail it."""

import numpy as np
import pytest
import torch

from lrbench import faults, jobs, profiling, run, spec

from lrbench.tests.conftest import SMALL, small_cell

CELLS = sorted(SMALL)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_program_on_the_cpu(name):
    cell = small_cell(name, **SMALL[name])
    job = jobs.make(cell, 2 ** 31 + 11, torch.device("cpu"))
    job.setup()
    job.run_window(1e-3, profiling.Recorder(False))  # one job
    job.release()
    ref = spec.reference(cell.config["reference"])
    w, _ = job.res
    pxy = np.stack([job.check_idx % w, job.check_idx // w], axis=-1)
    counts = ref.Counts()
    r = ref.render_pixels(job.scene, job.res, int(job.job_seeds[0]), job.spp, pxy, "cpu",
                          counts=counts).numpy()
    assert np.array_equal(r, job.kept[0])
    assert counts.closest + counts.shadow_open + counts.shadow_occluded == job.records[0].rays


def _run(cell, fault=None):
    hook = faults.FAULTS[fault] if fault else None
    undo = []
    result, checks = run.run_cell(cell, 2 ** 31 + 21, 0.5, 0, torch.device("cpu"), 0.0,
                                  hook=(lambda job: undo.append(hook(job))) if hook else None)
    for u in undo:
        u()
    return result, checks


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result, checks = _run(small_cell(name, **SMALL[name]))
    assert result["correct"] and all(c["value"] == 0.0 for c in checks.values())


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    result, checks = _run(small_cell(name, **SMALL[name]), fault)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    cell = small_cell(name, **SMALL[name])
    job = jobs.make(cell, 2 ** 31 + 31, torch.device("cpu"))
    job.setup()
    job.run_window(0.5, profiling.Recorder(False))
    job.release()
    numbers, _ = job.compare(precision_of_program="bf16")
    limits = cell.checks["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers
