"""Host tables built from the repo's code at first use and cached in
`luisarender_tpu_torch/_build/` (git-ignored).

A table's file name carries a hash of the modules it is computed from (and
numpy's version), so an edit to them builds it anew. It is written through
a temporary name and `os.replace`: a process never loads half a file, and
processes that build the same table at once each leave a whole one.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path

import numpy as np

_CORE = Path(__file__).resolve().parent


def table_path(stem: str, modules) -> Path:
    """The cache file of the table `stem`, computed from `modules` (paths
    relative to the package's core/ directory)."""
    from ..ops.build import BUILD_DIR

    src = b"".join((_CORE / m).read_bytes() for m in modules)
    key = hashlib.sha256(src + np.__version__.encode()).hexdigest()[:12]
    return BUILD_DIR / f"{stem}-{key}.npy"


def load_or_build(path: Path, build) -> np.ndarray:
    """The array in `path`, or build() saved there first."""
    if path.exists():
        return np.load(path)
    table = build()
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npy", dir=path.parent)
    with os.fdopen(fd, "wb") as f:
        np.save(f, table)
    os.replace(tmp, path)
    return table
