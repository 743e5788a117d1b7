"""Reachability + path selection (paper §3.3).

Covering a shape of orientations within the timestep is a metric-TSP
(pairwise rotation times satisfy the triangle inequality). MadEye uses the
MST 2-approximation with the heavy lifting precomputed:

  offline: pairwise distance matrix + full-grid MST (Prim);
  online:  induce the forest on the shape's cells, reconnect the few
           components with the cheapest cross edges, preorder-walk from the
           camera's current cell, sum rotation times.

Online cost is linear in shape size; the paper reports 14 µs per path and
92%-of-optimal paths — we assert the same order in tests/benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from repro_torch.core.grid import OrientationGrid


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


@dataclass
class PathPlanner:
    grid: OrientationGrid

    def __post_init__(self):
        self.dist = self.grid.angular_distance        # degrees
        self.mst_edges = prim_mst(self.dist)
        self.adj = [[] for _ in range(self.grid.n_cells)]
        for a, b in self.mst_edges:
            self.adj[a].append(b)
            self.adj[b].append(a)

    # ------------------------------------------------------------------
    def subtree_walk(self, cells: np.ndarray, start: int) -> list[int]:
        """Preorder walk visiting `cells` (bool mask), starting at `start`.

        Uses the precomputed full-grid MST restricted to the shape;
        disconnected components are stitched with their cheapest cross
        edge (still a 2-approx by the triangle inequality).
        """
        nodes = np.flatnonzero(cells)
        if nodes.size == 0:
            return []
        node_set = set(int(x) for x in nodes)
        if start not in node_set:
            start = int(nodes[np.argmin(self.dist[start][nodes])])

        # components of the induced forest
        comp = {}
        for n in node_set:
            if n in comp:
                continue
            stack, cid = [n], n
            comp[n] = cid
            while stack:
                u = stack.pop()
                for v in self.adj[u]:
                    if v in node_set and v not in comp:
                        comp[v] = cid
                        stack.append(v)

        # stitch components to the start's component greedily: cheapest
        # cross edge between the done set and the rest, ties broken by
        # row-major (u, v) node order so the fleet walk (kernels/shape_search)
        # makes the identical choice
        extra_adj: dict[int, list[int]] = {n: [] for n in node_set}
        done_nodes = sorted(n for n in node_set if comp[n] == comp[start])
        rest = sorted(node_set - set(done_nodes))
        while rest:
            sub = self.dist[np.ix_(done_nodes, rest)]
            k = np.unravel_index(np.argmin(sub), sub.shape)
            u, v = done_nodes[k[0]], rest[k[1]]
            extra_adj[u].append(v)
            extra_adj[v].append(u)
            joined = sorted(n for n in rest if comp[n] == comp[v])
            done_nodes = sorted(set(done_nodes) | set(joined))
            rest = [n for n in rest if comp[n] != comp[v]]

        # preorder DFS over (MST ∩ shape) + stitch edges
        order, seen, stack = [], set(), [start]
        while stack:
            u = stack.pop()
            if u in seen:
                continue
            seen.add(u)
            order.append(u)
            nbrs = [v for v in self.adj[u] if v in node_set] + extra_adj[u]
            # visit nearest-first (pop order reversed); ties toward the
            # lower cell id, deterministically (matches the fleet walk)
            nbrs = sorted(set(nbrs) - seen,
                          key=lambda v: (-self.dist[u][v], -v))
            stack.extend(nbrs)
        return order

    # ------------------------------------------------------------------
    def path_time(self, order: list[int], rotation_speed: float,
                  from_cell: int | None = None) -> float:
        """Seconds to traverse `order` (degrees / (deg/s))."""
        if not order:
            return 0.0
        t = 0.0
        prev = from_cell if from_cell is not None else order[0]
        for c in order:
            t += self.dist[prev][c] / rotation_speed
            prev = c
        return t

    def feasible(self, cells: np.ndarray, start: int, *,
                 rotation_speed: float, time_budget: float,
                 per_cell_cost: float = 0.0) -> tuple[bool, list[int], float]:
        """Can the shape be covered in `time_budget` seconds?

        per_cell_cost = capture + approx-model inference per orientation
        (pipelined with rotation in MadEye, so only the max matters; we
        charge the conservative sum of rotation + per-cell costs).
        """
        order = self.subtree_walk(cells, start)
        t = self.path_time(order, rotation_speed, from_cell=start)
        t += per_cell_cost * len(order)
        return t <= time_budget, order, t

    def shrink_to_budget(self, cells: np.ndarray, start: int, labels,
                         *, rotation_speed: float, time_budget: float,
                         per_cell_cost: float = 0.0,
                         grid: OrientationGrid | None = None):
        """Paper: 'upon failure, greedily remove the orientation with the
        lowest potential (that does not break contiguity) and recheck'."""
        from repro_torch.core.grid import removal_keeps_contiguity
        g = grid or self.grid
        cells = cells.copy()
        while True:
            ok, order, t = self.feasible(
                cells, start, rotation_speed=rotation_speed,
                time_budget=time_budget, per_cell_cost=per_cell_cost)
            if ok or cells.sum() <= 1:
                return cells, order, t
            cand = np.flatnonzero(cells)
            cand = sorted(cand, key=lambda c: labels[c])
            removed = False
            for c in cand:
                if cells[c] and removal_keeps_contiguity(cells, c, g):
                    cells[c] = False
                    removed = True
                    break
            if not removed:  # pathological; drop the worst regardless
                cells[cand[0]] = False


@lru_cache(maxsize=8)
def planner_for(grid: OrientationGrid) -> PathPlanner:
    return PathPlanner(grid)
