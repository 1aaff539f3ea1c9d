"""The flattened BVH layout, and the numpy Morton builder.

Counterpart of luisarender_tpu/accel/bvh.py. The port builds every
triangle tree with the binned-SAH builder of accel/native.py, which raises
where it cannot build (it has no Morton fallback). The Morton builder
(`build_bvh_boxes`) builds the two-level path's TLAS over instance boxes
(scene/compiler.py, accel/twolevel.py), bit for bit as the reference's:

- primitives sorted by the Morton code of their box centroid (10 bits an
  axis over the centroids' bounds), stably;
- leaves of `leaf_size` consecutive sorted primitives, the leaf count
  padded to a power of two, padded slots -1 with inverted boxes that no
  slab test hits unless a direction component is zero;
- a complete binary tree in heap layout, boxes by one vectorized sweep a
  level, converted to preorder with skip links.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BVHArrays(NamedTuple):
    """Flattened BVH in preorder DFS layout with skip links.

    Interior node i's first child is i+1 (preorder); `skip[i]` is the next
    node when the subtree rooted at i is culled (-1 = traversal done).
    Leaves have node_count > 0 and own prims order[node_first : +node_count]
    (the Morton builder's prim slots may be -1 padding)."""

    aabb_min: np.ndarray  # (N, 3) float32
    aabb_max: np.ndarray  # (N, 3) float32
    skip: np.ndarray  # (N,) int32
    node_first: np.ndarray  # (N,) int32: leaf first prim slot; -1 interior
    node_count: np.ndarray  # (N,) int32: leaf prim count; 0 interior
    prim_index: np.ndarray  # (P,) int32: sorted triangle order
    leaf_size: int


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis; x: (n, 3) in [0, 1024)."""
    x = x.astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (spread(x[:, 0]) << np.uint64(2)) | (spread(x[:, 1]) << np.uint64(1)) | spread(
        x[:, 2]
    )


def build_bvh(positions: np.ndarray, triangles: np.ndarray, leaf_size: int = 4) -> BVHArrays:
    """Morton tree over triangles; positions (V, 3) float32, triangles (T, 3)
    int32."""
    positions = np.asarray(positions, dtype=np.float32)
    triangles = np.asarray(triangles, dtype=np.int32)
    if triangles.shape[0] == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    v0 = positions[triangles[:, 0]]
    v1 = positions[triangles[:, 1]]
    v2 = positions[triangles[:, 2]]
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    return build_bvh_boxes(tri_min, tri_max, leaf_size)


def build_bvh_boxes(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int = 4) -> BVHArrays:
    """Morton tree over primitive boxes (T, 3) min / max."""
    tri_min = np.asarray(tri_min, np.float32)
    tri_max = np.asarray(tri_max, np.float32)
    t = tri_min.shape[0]
    centroid = (tri_min + tri_max) * 0.5

    scene_min = centroid.min(axis=0)
    scene_ext = np.maximum(centroid.max(axis=0) - scene_min, 1e-12)
    quantized = np.clip(
        ((centroid - scene_min) / scene_ext * 1023.0), 0.0, 1023.0
    ).astype(np.uint32)
    order = np.argsort(_morton3(quantized), kind="stable").astype(np.int32)

    num_leaves_raw = -(-t // leaf_size)
    num_leaves = 1 << max(0, int(np.ceil(np.log2(max(num_leaves_raw, 1)))))
    prim_index = np.full(num_leaves * leaf_size, -1, dtype=np.int32)
    prim_index[:t] = order

    # leaf boxes; padded slots get inverted boxes
    big = np.float32(3.0e38)
    leaf_min = np.full((num_leaves, leaf_size, 3), big, dtype=np.float32)
    leaf_max = np.full((num_leaves, leaf_size, 3), -big, dtype=np.float32)
    flat_min = leaf_min.reshape(-1, 3)
    flat_max = leaf_max.reshape(-1, 3)
    flat_min[:t] = tri_min[order]
    flat_max[:t] = tri_max[order]

    # heap layout: interior nodes 0..L-2, leaves L-1..2L-2; boxes bottom-up,
    # one vectorized sweep a level
    n_nodes = 2 * num_leaves - 1
    aabb_min = np.empty((n_nodes, 3), dtype=np.float32)
    aabb_max = np.empty((n_nodes, 3), dtype=np.float32)
    aabb_min[num_leaves - 1:] = leaf_min.min(axis=1)
    aabb_max[num_leaves - 1:] = leaf_max.max(axis=1)
    level_start = num_leaves - 1
    while level_start > 0:
        parent_start = (level_start - 1) // 2
        parents = np.arange(parent_start, level_start)
        left = 2 * parents + 1
        right = left + 1
        aabb_min[parents] = np.minimum(aabb_min[left], aabb_min[right])
        aabb_max[parents] = np.maximum(aabb_max[left], aabb_max[right])
        level_start = parent_start

    # heap order -> preorder with skip links (an explicit stack of (heap
    # index, skip target in preorder numbering))
    first_leaf = num_leaves - 1
    preorder = np.empty(n_nodes, dtype=np.int64)  # preorder position -> heap index
    skip = np.full(n_nodes, -1, dtype=np.int32)
    node_first = np.full(n_nodes, -1, dtype=np.int32)
    node_count = np.zeros(n_nodes, dtype=np.int32)
    stack = [(0, -1)]
    pos = 0
    while stack:
        heap_i, sk = stack.pop()
        preorder[pos] = heap_i
        skip[pos] = sk
        if heap_i >= first_leaf:
            node_first[pos] = (heap_i - first_leaf) * leaf_size
            node_count[pos] = leaf_size
        else:
            left, right = 2 * heap_i + 1, 2 * heap_i + 2
            # the right subtree follows the left one in preorder
            right_pos = pos + 1 + _subtree_size(left, num_leaves)
            stack.append((right, sk))
            stack.append((left, right_pos))
        pos += 1

    return BVHArrays(
        aabb_min=aabb_min[preorder],
        aabb_max=aabb_max[preorder],
        skip=skip,
        node_first=node_first,
        node_count=node_count,
        prim_index=prim_index,
        leaf_size=leaf_size,
    )


def _subtree_size(heap_i: int, num_leaves: int) -> int:
    """Nodes of the subtree at heap index heap_i of a complete tree with
    num_leaves (a power of two) leaves: 2^(H - depth + 1) - 1, H =
    log2(num_leaves)."""
    if num_leaves <= 1:
        return 1
    h = num_leaves.bit_length() - 1
    depth = (heap_i + 1).bit_length() - 1
    return (1 << (h - depth + 1)) - 1
