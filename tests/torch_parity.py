"""Helpers of the port's parity tests (tests/test_torch_*.py): the
reference's native SAH builder, and the inputs those tests share.

Importing it also leaves torch one intra-op thread: the suite runs under
pytest-xdist with a worker for nearly every core, and torch's threads on
the port's small CPU tensors only contend there (a render test file that
takes 54 s alone took 690 s under six workers with torch's default eight
threads each; with one thread it takes 42 s alone)."""

import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def require_reference_builder():
    """Make sure luisarender_tpu's native SAH builder is loaded, so that its
    compiler sorts triangles by the same binned-SAH tree as the port's and
    never by its numpy Morton fallback. A process whose first load failed
    (a library another process was still writing, for one) gets its flags
    reset and loads again; fails the test if the builder stays unavailable."""
    from luisarender_tpu.accel import native

    for attempt in range(5):
        if native._LIB is not None:
            return native
        native._LIB = None
        native._LIB_FAILED = False
        native._load()
        if native._LIB is None:
            time.sleep(1.0 + attempt)
    pytest.fail("the reference's native SAH builder (luisarender_tpu/accel/native.py) "
                "could not be loaded; the parity tests never compare against its "
                "Morton fallback")


def soup(n_tris, seed=1):
    """Random small triangles in the unit cube (tests/test_cluster_trace.py
    `_soup`): positions (3T, 3) float32, triangles (T, 3) int32."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (n_tris, 3)).astype(np.float32)
    a = (c + rng.normal(0, 0.05, (n_tris, 3))).astype(np.float32)
    b = (c + rng.normal(0, 0.05, (n_tris, 3))).astype(np.float32)
    d = (c + rng.normal(0, 0.05, (n_tris, 3))).astype(np.float32)
    positions = np.concatenate([a, b, d], 0).astype(np.float32)
    idx = np.arange(n_tris)
    triangles = np.stack([idx, idx + n_tris, idx + 2 * n_tris], 1).astype(np.int32)
    return positions, triangles
