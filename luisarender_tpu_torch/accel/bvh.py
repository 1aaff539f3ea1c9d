"""The flattened BVH that the SAH builder returns.

Counterpart of `BVHArrays` in luisarender_tpu/accel/bvh.py. The reference's
numpy Morton builder (`build_bvh`, `build_bvh_boxes`) comes with the
two-level slice; the port builds every tree with the binned-SAH builder of
accel/native.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BVHArrays(NamedTuple):
    """Flattened BVH in preorder DFS layout with skip links.

    Interior node i's first child is i+1 (preorder); `skip[i]` is the next
    node when the subtree rooted at i is culled (-1 = traversal done).
    Leaves have node_count > 0 and own prims order[node_first : +node_count]."""

    aabb_min: np.ndarray  # (N, 3) float32
    aabb_max: np.ndarray  # (N, 3) float32
    skip: np.ndarray  # (N,) int32
    node_first: np.ndarray  # (N,) int32: leaf first prim slot; -1 interior
    node_count: np.ndarray  # (N,) int32: leaf prim count; 0 interior
    prim_index: np.ndarray  # (P,) int32: sorted triangle order
    leaf_size: int
