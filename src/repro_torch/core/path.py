"""Offline path geometry (paper §3.3): the full-grid MST the online
preorder walk (the budget_walk kernel and its plain version
kernels/shape_search/ops.walk) restricts to each shape."""
from __future__ import annotations

import numpy as np


def prim_mst(dist: np.ndarray) -> list[tuple[int, int]]:
    """MST edges over a dense distance matrix (Prim, O(n^2))."""
    n = dist.shape[0]
    in_tree = np.zeros(n, bool)
    best = np.full(n, np.inf)
    parent = np.full(n, -1)
    best[0] = 0.0
    edges = []
    for _ in range(n):
        i = int(np.argmin(np.where(in_tree, np.inf, best)))
        in_tree[i] = True
        if parent[i] >= 0:
            edges.append((int(parent[i]), i))
        improve = dist[i] < best
        mask = improve & ~in_tree
        best[mask] = dist[i][mask]
        parent[mask] = i
    return edges
