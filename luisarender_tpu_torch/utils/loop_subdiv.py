"""Loop subdivision of triangle meshes.

Counterpart of luisarender_tpu/utils/loop_subdiv.py, the same host-side
numpy code: each triangle splits into four; new edge vertices use the
3/8-1/8 stencil (1/2-1/2 at boundaries), and original vertices are
repositioned with Loop's beta weights (boundary vertices use the
1/8-3/4-1/8 curve rule). Neighbours are visited in the same set order, so
the sums round as the reference's."""

from __future__ import annotations

import numpy as np


def loop_subdivide(positions: np.ndarray, triangles: np.ndarray, levels: int = 1):
    p = np.asarray(positions, np.float64)
    t = np.asarray(triangles, np.int64)
    for _ in range(max(levels, 0)):
        p, t = _subdivide_once(p, t)
    return p.astype(np.float32), t.astype(np.int32)


def _subdivide_once(p: np.ndarray, t: np.ndarray):
    nv = p.shape[0]
    # edge -> (opposite vertices, count) maps
    edge_mid: dict = {}
    edge_opp: dict = {}
    neighbors: dict = {i: set() for i in range(nv)}
    boundary_adj: dict = {i: set() for i in range(nv)}

    def ekey(a, b):
        return (min(a, b), max(a, b))

    for tri in t:
        for i in range(3):
            a, b = int(tri[i]), int(tri[(i + 1) % 3])
            c = int(tri[(i + 2) % 3])
            edge_opp.setdefault(ekey(a, b), []).append(c)
            neighbors[a].add(b)
            neighbors[b].add(a)

    boundary_edges = {e for e, opp in edge_opp.items() if len(opp) == 1}
    for a, b in boundary_edges:
        boundary_adj[a].add(b)
        boundary_adj[b].add(a)

    # new edge vertices
    new_pts = []
    for e, opp in edge_opp.items():
        a, b = e
        if len(opp) >= 2:
            v = 0.375 * (p[a] + p[b]) + 0.125 * (p[opp[0]] + p[opp[1]])
        else:
            v = 0.5 * (p[a] + p[b])
        edge_mid[e] = nv + len(new_pts)
        new_pts.append(v)

    # reposition original vertices
    moved = np.empty_like(p)
    for i in range(nv):
        if boundary_adj[i]:
            adj = list(boundary_adj[i])
            if len(adj) >= 2:
                moved[i] = 0.75 * p[i] + 0.125 * (p[adj[0]] + p[adj[1]])
            else:
                moved[i] = p[i]
        else:
            n = len(neighbors[i])
            if n < 3:
                moved[i] = p[i]
                continue
            beta = (
                (0.625 - (0.375 + 0.25 * np.cos(2.0 * np.pi / n)) ** 2) / n
            )
            moved[i] = (1.0 - n * beta) * p[i] + beta * sum(
                p[j] for j in neighbors[i]
            )

    new_p = np.concatenate([moved, np.asarray(new_pts)], axis=0)
    new_t = []
    for tri in t:
        a, b, c = int(tri[0]), int(tri[1]), int(tri[2])
        ab = edge_mid[ekey(a, b)]
        bc = edge_mid[ekey(b, c)]
        ca = edge_mid[ekey(c, a)]
        new_t += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return new_p, np.asarray(new_t, np.int64)
