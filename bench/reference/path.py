"""Reachability + path selection (paper §3.3).

Covering a shape of orientations within the timestep is a metric-TSP
(pairwise rotation times satisfy the triangle inequality). MadEye uses the
MST 2-approximation with the heavy lifting precomputed:

  offline: pairwise distance matrix + full-grid MST (Prim);
  online:  induce the forest on the shape's cells, reconnect the few
           components with the cheapest cross edges, preorder-walk from the
           camera's current cell, sum rotation times.

Here only the offline MST (`prim_mst`), which the fleet's geometry is
built from.
"""
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


