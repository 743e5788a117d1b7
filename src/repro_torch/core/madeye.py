"""MadEyeController — ties search + rank + zoom + tradeoff per timestep
(paper Fig. 8 end-to-end workflow, camera side).

The controller is deliberately I/O-free: the serving pipeline hands it an
`observe` callback that captures + approx-scores a set of (cell, zoom)
orientations, and the controller returns which explored frames to ship to
the backend. Host-side state is numpy (this is the camera-CPU logic the
paper measures at 17 µs/step); the fleet-scale PyTorch step over a [F, ...]
camera batch is repro_torch/fleet/step.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.core import rank as rank_mod
from repro_torch.core import search, tradeoff, zoom as zoom_mod
from repro_torch.core.grid import OrientationGrid
from repro_torch.core.path import PathPlanner, planner_for
from repro_torch.core.rank import Workload

EWMA_ALPHA = 2.0 / 11.0      # window 10 (paper §3.3)


class Observation(NamedTuple):
    """What the approximation models saw in one explored orientation."""
    counts: dict          # (model, obj) -> int
    areas: dict           # (model, obj) -> float (sum of box areas)
    centroid: np.ndarray  # [2] mean box center, scene degrees
    has_boxes: bool
    box_centers: np.ndarray  # [K, 2] scene degrees
    box_sizes: np.ndarray    # [K, 2] scene degrees


class StepResult(NamedTuple):
    explored: list            # cell ids in visit order
    zooms: np.ndarray         # zoom index per explored cell
    sent: list                # cell ids shipped to backend (rank order)
    pred_acc: np.ndarray      # predicted workload accuracy per explored cell
    path_time: float


@dataclass
class MadEyeController:
    grid: OrientationGrid
    workload: Workload
    budget: tradeoff.BudgetConfig = field(
        default_factory=tradeoff.BudgetConfig)
    search_cfg: search.SearchConfig = field(
        default_factory=search.SearchConfig)
    zoom_cfg: zoom_mod.ZoomConfig = field(default_factory=zoom_mod.ZoomConfig)
    delta_weight: float = 0.5

    def __post_init__(self):
        n = self.grid.n_cells
        self.planner: PathPlanner = planner_for(self.grid)
        self.net = tradeoff.NetworkEstimator()
        self.zoom_state = zoom_mod.ZoomState.create(n)
        self.shape = search.seed_shape(self.grid, 6)
        self.current_cell = int(np.flatnonzero(self.shape)[0])
        # EWMA label state (numpy mirror of core/ewma.py)
        self.acc_ewma = np.zeros(n)
        self.delta_ewma = np.zeros(n)
        self.last_acc = np.zeros(n)
        self.visits = np.zeros(n)
        self.centroids = np.zeros((n, 2))
        self.has_boxes = np.zeros(n, bool)
        self.cell_boxes: dict = {}  # cell -> (centers [K,2], sizes [K,2])
        self.train_acc = 0.85       # backend-reported approx-model accuracy
        self.pred_var = 0.25
        self.saw_objects = True
        self.step_idx = 0
        self.last_visit = np.full(n, -1000, dtype=np.int64)
        self.scout_every = 8  # 1-cell regime: periodic scout visit

    # ------------------------------------------------------------------
    def labels(self) -> np.ndarray:
        raw = self.acc_ewma + self.delta_weight * self.delta_ewma
        return np.maximum(raw, 0.0) + 1e-3

    def _update_ewma(self, cells: np.ndarray, values: np.ndarray):
        for c, v in zip(cells, values):
            first = self.visits[c] == 0
            if first:
                self.acc_ewma[c] = v
                self.delta_ewma[c] = 0.0
            else:
                self.acc_ewma[c] = (EWMA_ALPHA * v
                                    + (1 - EWMA_ALPHA) * self.acc_ewma[c])
                d = v - self.last_acc[c]
                self.delta_ewma[c] = (EWMA_ALPHA * d
                                      + (1 - EWMA_ALPHA) * self.delta_ewma[c])
            self.last_acc[c] = v
            self.visits[c] += 1

    # ------------------------------------------------------------------
    def step(self, observe: Callable[[list, np.ndarray], list]) -> StepResult:
        """One timestep. `observe(cells, zoom_idx)` must return a list of
        `Observation` (one per cell, same order).

        The fleet-scale version of this method is
        repro_torch.fleet.step.fleet_step; tests/test_torch_tables.py
        keeps the two decision-identical."""
        g = self.grid

        # 1. budget: frames to send + target shape size
        k_send, t_explore, max_cells = tradeoff.plan_timestep(
            self.train_acc, self.pred_var, self.net, self.budget)

        # 2. shape: reset on empty scene, else evolve + resize to budget
        if not self.saw_objects:
            # Re-seed around the most promising stale cell: EWMA labels
            # break ties toward least-recently-visited, so empty scenes
            # degrade into a systematic sweep instead of a dead-zone lock.
            staleness = (self.step_idx - self.last_visit).astype(float)
            center = int(np.argmax(self.labels() + 1e-4 * staleness))
            self.shape = search.seed_shape(g, max_cells, center)
            newly = np.flatnonzero(self.shape)
            self.zoom_state = zoom_mod.reset_cells(self.zoom_state, newly)
        else:
            prev = self.shape.copy()
            self.shape = search.evolve_shape(
                g, self.shape, self.labels(), self.centroids,
                self.has_boxes, self.search_cfg)
            self.shape = search.resize_shape(
                g, self.shape, self.labels(), self.centroids,
                self.has_boxes, max_cells)
            # 1-cell regime: the camera would otherwise never learn about
            # the rest of the grid — spend every Nth timestep scouting the
            # most promising stale cell (EWMA label + staleness bonus)
            if (max_cells == 1 and self.scout_every
                    and self.step_idx % self.scout_every
                    == self.scout_every - 1):
                staleness = (self.step_idx - self.last_visit).astype(float)
                score = self.labels() + 1e-3 * np.sqrt(
                    np.maximum(staleness, 0.0))
                score[np.flatnonzero(self.shape)] = -np.inf
                scout = int(np.argmax(score))
                self.shape = np.zeros(g.n_cells, bool)
                self.shape[scout] = True
            newly = np.flatnonzero(self.shape & ~prev)
            if newly.size:
                self.zoom_state = zoom_mod.reset_cells(self.zoom_state, newly)

        # 3. reachability: shrink until coverable in the exploration budget
        #    (timestep minus transmission + backend inference — §3.3).
        #    Rotation overlaps approx inference, so the per-cell charge is
        #    the slack of inference over one hop (usually zero).
        hop_s = g.pan_step / self.budget.rotation_speed
        per_cell = max(0.0, self.budget.approx_infer_s - hop_s)
        budget_s = max(t_explore - self.budget.approx_infer_s,
                       self.budget.approx_infer_s + hop_s)
        self.shape, order, path_time = self.planner.shrink_to_budget(
            self.shape, self.current_cell, self.labels(),
            rotation_speed=self.budget.rotation_speed,
            time_budget=budget_s, per_cell_cost=per_cell)

        # 4. zoom per explored cell (driven by last timestep's boxes)
        empty = (np.zeros((0, 2)), np.zeros((0, 2)))
        per_cell_boxes = {c: self.cell_boxes.get(c, empty) for c in order}
        self.zoom_state, zoom_idx = zoom_mod.step(
            g, self.zoom_cfg, self.zoom_state, np.asarray(order),
            per_cell_boxes, self.budget.timestep)
        zooms = zoom_idx[np.asarray(order, int)] if order else np.zeros(0, int)

        # 5. observe (capture + approx inference along the path)
        obs = observe(order, zooms)

        # 6. rank explored orientations by predicted workload accuracy
        K = len(order)
        per_q_counts = {}
        per_q_areas = {}
        for q in self.workload.queries:
            key = (q.model, q.obj)
            per_q_counts.setdefault(
                key, np.array([o.counts.get(key, 0) for o in obs], float))
            per_q_areas.setdefault(
                key, np.array([o.areas.get(key, 0.0) for o in obs], float))
        visits = self.visits[np.asarray(order, int)] if order else np.zeros(0)
        pred_acc = rank_mod.predict_workload_accuracy(
            self.workload, per_q_counts, per_q_areas, visits)
        ranking = rank_mod.rank_orientations(pred_acc)
        sent = [order[i] for i in ranking[:k_send]]

        # 7. state updates
        self.step_idx += 1
        cells_arr = np.asarray(order, int)
        self.last_visit[cells_arr] = self.step_idx
        self._update_ewma(cells_arr, pred_acc)
        # stale-cell optimism decay (unvisited highs drift down)
        unvisited = np.ones(g.n_cells, bool)
        unvisited[cells_arr] = False
        self.acc_ewma[unvisited] *= 0.995
        for c, o in zip(order, obs):
            self.has_boxes[c] = o.has_boxes
            if o.has_boxes:
                self.centroids[c] = o.centroid
            self.cell_boxes[c] = (o.box_centers, o.box_sizes)
        self.saw_objects = any(o.has_boxes for o in obs)
        self.pred_var = float(np.var(pred_acc)) if K > 1 else 0.0
        self.current_cell = order[-1] if order else self.current_cell

        return StepResult(order, zooms, sent, pred_acc, path_time)

    # ------------------------------------------------------------------
    def report_network(self, mbps: float, rtt_s: float | None = None):
        self.net.observe(mbps, rtt_s)

    def report_train_acc(self, acc: float):
        self.train_acc = float(np.clip(acc, 0.0, 1.0))
