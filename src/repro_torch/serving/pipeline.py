"""End-to-end MadEye serving loop (paper Fig. 8).

Per timestep: the controller plans shape/zoom/path -> the camera sweeps the
orientations -> approximation-model proxies score each (degraded teacher
outputs — the student mimics the teacher, §3.1) -> top-k frames ship over
the network trace -> the backend scores true workload accuracy and feeds
rank-agreement (training accuracy) back to the controller.

`run_madeye` is the reference single-camera loop used by every benchmark;
`run_scheme` evaluates the baselines on identical substrate.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import baselines as bl
from repro_torch.core.madeye import MadEyeController, Observation
from repro_torch.core.rank import Workload
from repro_torch.core.tradeoff import BudgetConfig
from repro_torch.data.dataset import Video, largest_object_table, motion_table
from repro_torch.data.render import boxes_to_scene
from repro_torch.serving import accuracy as acc_mod
from repro_torch.serving.camera import PTZCamera
from repro_torch.serving.transport import NetworkTrace

ZOOM_LEVELS = (1.0, 2.0, 3.0)


@dataclass
class RunResult:
    accuracy: float
    visited: dict                 # {frame: [(cell, zoom_idx)]} shipped
    explored: dict                # {frame: [cells]} explored
    frames_sent: int
    mean_shape: float
    best_explored_rate: float


def _observation_from_tables(tables, workload: Workload, grid, t, cell,
                             zoom_idx, approx_miss: float) -> Observation:
    from repro_torch.serving.teachers import approx_observation
    z = ZOOM_LEVELS[zoom_idx]
    counts, areas = {}, {}
    all_centers, all_sizes = [], []
    for key in {(q.model, q.obj) for q in workload.queries}:
        det = tables[key].dets[z][t][cell]
        ap = approx_observation(det, miss_rate=approx_miss,
                                seed_key=(t, cell))
        counts[key] = ap["count"]
        boxes = ap["boxes"]
        areas[key] = float((boxes[:, 2] * boxes[:, 3]).sum()) if len(boxes) \
            else 0.0
        if len(boxes):
            c, s = boxes_to_scene(boxes, grid, cell, z)
            all_centers.append(c)
            all_sizes.append(s)
    if all_centers:
        centers = np.concatenate(all_centers, 0)
        sizes = np.concatenate(all_sizes, 0)
    else:
        centers = np.zeros((0, 2))
        sizes = np.zeros((0, 2))
    return Observation(
        counts=counts, areas=areas,
        centroid=centers.mean(0) if len(centers) else np.zeros(2),
        has_boxes=len(centers) > 0,
        box_centers=centers, box_sizes=sizes)


def run_madeye(video: Video, workload: Workload, tables: dict,
               budget: BudgetConfig, trace: NetworkTrace, *,
               approx_miss: float = 0.12,
               acc_table: np.ndarray | None = None) -> RunResult:
    grid = video.grid
    ctrl = MadEyeController(grid, workload, budget=budget)
    camera = PTZCamera(grid, rotation_speed=budget.rotation_speed)
    if acc_table is None:
        acc_table = acc_mod.workload_acc_table(video, workload, tables,
                                               ZOOM_LEVELS)
    T = video.n_frames
    # the controller runs once per RESPONSE timestep; the video advances
    # at its own rate in between (stride frames per timestep)
    stride = max(1, int(round(video.fps / budget.fps)))
    visited, explored_hist = {}, {}
    shape_sizes, best_hits, sent_total = [], [], 0

    for t in range(0, T, stride):
        ctrl.report_network(trace.observed_mbps(t), trace.rtt_s)

        def observe(cells, zooms, _t=t):
            return [_observation_from_tables(
                tables, workload, grid, _t, c, int(zi), approx_miss)
                for c, zi in zip(cells, zooms)]

        res = ctrl.step(observe)
        camera.sweep(res.explored)
        zoom_of = {c: int(z) for c, z in zip(res.explored, res.zooms)}
        sent = [(c, zoom_of[c]) for c in res.sent]
        visited[t] = sent
        explored_hist[t] = list(res.explored)
        sent_total += len(sent)
        shape_sizes.append(len(res.explored))

        # backend feedback: did the approx ranking pick the truly-best
        # explored orientation? (training-accuracy proxy, §3.3)
        if len(res.explored) > 1:
            true_vals = [acc_table[t, c, zoom_of[c]] for c in res.explored]
            agree = float(res.explored[int(np.argmax(res.pred_acc))]
                          == res.explored[int(np.argmax(true_vals))])
            ctrl.report_train_acc(0.9 * ctrl.train_acc + 0.1 * agree)

        best_cell = int(np.argmax(acc_table[t].max(-1)))
        best_hits.append(best_cell in res.explored)

    accuracy = acc_mod.evaluate_selection(video, workload, tables, visited,
                                          ZOOM_LEVELS)
    return RunResult(accuracy, visited, explored_hist, sent_total,
                     float(np.mean(shape_sizes)), float(np.mean(best_hits)))


def run_madeye_topk(video: Video, workload: Workload, tables: dict,
                    budget: BudgetConfig, trace: NetworkTrace, k: int, *,
                    approx_miss: float = 0.12,
                    acc_table: np.ndarray | None = None) -> RunResult:
    """MadEye-k (Table 1): fixed number of frames shipped per timestep."""
    b = BudgetConfig(**{**budget.__dict__, "min_send": k, "max_send": k})
    return run_madeye(video, workload, tables, b, trace,
                      approx_miss=approx_miss, acc_table=acc_table)


# ---------------------------------------------------------------------------
# Baseline harness on the same substrate
# ---------------------------------------------------------------------------

def run_scheme(video: Video, workload: Workload, tables: dict, scheme: str,
               *, k: int = 1, budget: BudgetConfig | None = None,
               acc_table: np.ndarray | None = None) -> RunResult:
    """scheme in {one_time_fixed, best_fixed, best_dynamic, panoptes,
    tracking, ucb1}. Oracle schemes pick (cell, zoom) jointly from the
    flattened 75-orientation table, mirroring §2.2."""
    grid = video.grid
    if acc_table is None:
        acc_table = acc_mod.workload_acc_table(video, workload, tables,
                                               ZOOM_LEVELS)
    T, N, Z = acc_table.shape
    flat = acc_table.reshape(T, N * Z)

    def unflat(idx):
        return (int(idx) // Z, int(idx) % Z)

    stride = 1
    if budget is not None:
        stride = max(1, int(round(video.fps / budget.fps)))
    frames = list(range(0, T, stride))
    sub = flat[frames]

    if scheme == "one_time_fixed":
        choices = bl.one_time_fixed(sub)
        rows = [[unflat(c)] for c in choices]
    elif scheme == "best_fixed":
        ch = bl.best_fixed(sub, k=k)
        if k == 1:
            rows = [[unflat(c)] for c in ch]
        else:
            rows = [[unflat(c) for c in row] for row in ch]
    elif scheme == "best_dynamic":
        choices = bl.best_dynamic(sub)
        rows = [[unflat(c)] for c in choices]
    elif scheme == "panoptes":
        motion = motion_table(video)[frames]
        # Panoptes schedules over cells at best zoom per cell
        best_z = acc_table.mean(0).argmax(-1)          # [N]
        cell_acc = acc_table.mean(-1)[frames]
        choices = bl.panoptes(cell_acc, motion, grid=grid)
        rows = [[(int(c), int(best_z[c]))] for c in choices]
    elif scheme == "tracking":
        sizes, cells = largest_object_table(video)
        home = int(np.argmax(acc_table.mean(0).max(-1)))
        choices = bl.tracking(sizes[frames], cells[frames], home, grid)
        best_z = acc_table.mean(0).argmax(-1)
        rows = [[(int(c), int(best_z[c]))] for c in choices]
    elif scheme == "ucb1":
        choices = bl.ucb1(sub)
        rows = [[unflat(c)] for c in choices]
    else:
        raise ValueError(scheme)

    visited = {t: row for t, row in zip(frames, rows)}
    accuracy = acc_mod.evaluate_selection(video, workload, tables, visited,
                                          ZOOM_LEVELS)
    explored = {t: [c for (c, _) in visited[t]] for t in frames}
    hits = [int(np.argmax(flat[t])) // Z in explored[t] for t in frames]
    return RunResult(accuracy, visited, explored,
                     sum(len(v) for v in visited.values()),
                     float(np.mean([len(v) for v in visited.values()])),
                     float(np.mean(hits)))
