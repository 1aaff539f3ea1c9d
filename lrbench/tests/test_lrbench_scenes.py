"""The frozen scenes against stored hashes of the dicts handed to the
program and the reference."""

import hashlib
import json

import pytest

from lrbench import jobs, spec

SCENES = {
    "cornell.final_1024": "db3b8dbfc1779cb30bb9cade365a2ac37bd50ac9ade819181618ebf4d46ab2ce",
}


def _scene_hash(name):
    cell = spec.cell(name)
    d = jobs.scene_dict(cell.config, cell.traffic)
    text = json.dumps(d, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_dicts_are_frozen(name):
    assert _scene_hash(name) == SCENES[name]


def test_job_seeds_and_pixels_follow_the_seed():
    cell = spec.cell("cornell.final_1024")
    a = jobs.RenderJobs(cell, 2 ** 31 + 5, "cpu")
    b = jobs.RenderJobs(cell, 2 ** 31 + 5, "cpu")
    c = jobs.RenderJobs(cell, 2 ** 31 + 6, "cpu")
    assert (a.job_seeds == b.job_seeds).all() and (a.check_idx == b.check_idx).all()
    assert (a.job_seeds != c.job_seeds).any()
    assert a.check_idx.size == cell.checks["pixels"]
