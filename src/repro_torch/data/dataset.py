"""Dataset utilities: precomputed accuracy tables + training batches.

`build_video` rolls a Scene forward and materializes, per frame, the
ground-truth view of every orientation cell — the substrate for oracle
baselines, MadEye evaluation, and the per-figure benchmarks. This is the
analogue of the paper running every workload on all 75 orientations of
each video (§2.2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.grid import OrientationGrid
from repro_torch.data.render import gt_boxes
from repro_torch.data.scene import Scene, SceneConfig
from repro_torch.scene.scene import OBJ_IDS  # noqa: F401  (re-exported)


@dataclass
class Video:
    """Precomputed per-frame, per-cell ground truth for one scene."""
    grid: OrientationGrid
    fps: int
    snapshots: list            # [T] scene snapshots
    # gt[t][cell] -> dict(boxes, classes, ids, apparent) at zoom 1
    gt: list
    # gt_zoom[z][t][cell] for zoom levels (1-indexed into zoom_levels)
    gt_zoom: dict

    @property
    def n_frames(self) -> int:
        return len(self.snapshots)


def build_video(grid: OrientationGrid, cfg: SceneConfig, duration_s: float,
                zoom_levels=(1.0, 2.0, 3.0)) -> Video:
    scene = Scene(cfg)
    T = int(duration_s * cfg.fps)
    snapshots, gt_all = [], []
    gt_zoom = {z: [] for z in zoom_levels}
    for t in range(T):
        scene.step()
        snap = scene.snapshot()
        snapshots.append(snap)
        gt_all.append([gt_boxes(snap, grid, c, zoom_levels[0])
                       for c in range(grid.n_cells)])
        for z in zoom_levels:
            if z == zoom_levels[0]:
                gt_zoom[z].append(gt_all[-1])
            else:
                gt_zoom[z].append([gt_boxes(snap, grid, c, z)
                                   for c in range(grid.n_cells)])
    return Video(grid, cfg.fps, snapshots, gt_all, gt_zoom)


def motion_table(video: Video) -> np.ndarray:
    """[T, n_cells] motion proxy: count of objects whose position moved
    within the cell's FOV since the previous frame (Panoptes input)."""
    T, N = video.n_frames, video.grid.n_cells
    out = np.zeros((T, N))
    for t in range(1, T):
        for c in range(N):
            prev_ids = set(video.gt[t - 1][c]["ids"].tolist())
            cur_ids = set(video.gt[t][c]["ids"].tolist())
            out[t, c] = len(cur_ids | prev_ids) - len(cur_ids & prev_ids) \
                + 0.5 * len(cur_ids & prev_ids)
    return out


def largest_object_table(video: Video):
    """([T] size of globally largest object, [T] cell containing it)."""
    T = video.n_frames
    sizes = np.zeros(T)
    cells = np.zeros(T, int)
    for t in range(T):
        best_s, best_c = 0.0, 0
        for c in range(video.grid.n_cells):
            a = video.gt[t][c]["apparent"]
            if a.size and a.max() > best_s:
                best_s, best_c = float(a.max()), c
        sizes[t], cells[t] = best_s, best_c
    return sizes, cells
