"""Zoom controller (paper §3.3 "Handling zoom").

Past accuracies can't reveal what a different zoom would have seen, so the
controller is driven by bbox geometry from the approximation models:

  * a cell newly added to the shape starts at the lowest zoom (full
    visibility);
  * per timestep, the mean distance of each box to the bbox centroid is
    compared against the area covered by each zoom factor — tight clusters
    are safe to zoom into;
  * cells auto-zoom out after `zoom_out_after` seconds (default 3 s per
    the paper) so newly entering objects aren't missed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bench.reference.grid import OrientationGrid


@dataclass
class ZoomConfig:
    zoom_levels: tuple = (1.0, 2.0, 3.0)
    zoom_out_after: float = 3.0      # seconds
    margin: float = 0.7              # cluster must fit in margin * FOV/2


@dataclass
class ZoomState:
    zoom_idx: np.ndarray             # [n_cells] int — index into zoom_levels
    zoomed_since: np.ndarray         # [n_cells] float — s at > min zoom

    @classmethod
    def create(cls, n_cells: int) -> "ZoomState":
        return cls(np.zeros(n_cells, np.int32), np.zeros(n_cells))


def select_zoom(grid: OrientationGrid, cfg: ZoomConfig, state: ZoomState,
                cell: int, box_centers: np.ndarray, box_sizes: np.ndarray,
                dt: float) -> int:
    """Choose the zoom index for `cell` this timestep.

    box_centers [K, 2] / box_sizes [K, 2] in scene degrees for boxes the
    approximation model saw in this cell (K may be 0).
    """
    zi = int(state.zoom_idx[cell])
    # forced zoom-out timer
    if zi > 0 and state.zoomed_since[cell] + dt >= cfg.zoom_out_after:
        return 0
    if box_centers.shape[0] == 0:
        return 0  # nothing visible: widest view

    centroid = box_centers.mean(0)
    spread = np.linalg.norm(box_centers - centroid, axis=1).mean()
    extent = box_sizes.max() if box_sizes.size else 0.0
    cluster_radius = spread + extent

    # deepest zoom whose (margin-shrunk) half-FOV still contains the cluster
    best = 0
    cell_center = grid.centers[cell]
    off = np.linalg.norm(box_centers.mean(0) - cell_center)
    for i, z in enumerate(cfg.zoom_levels):
        fw, fh = grid.fov(z)
        half = min(fw, fh) / 2.0
        if (cluster_radius + off) <= cfg.margin * half:
            best = i
    return best


def step(grid: OrientationGrid, cfg: ZoomConfig, state: ZoomState,
         shape_cells: np.ndarray, per_cell_boxes: dict, dt: float
         ) -> tuple[ZoomState, np.ndarray]:
    """Advance zoom state for all cells in the shape.

    per_cell_boxes: {cell: (centers [K,2], sizes [K,2])} in scene degrees.
    Returns (new_state, zoom_idx_per_cell [n_cells]).
    """
    zi = state.zoom_idx.copy()
    zs = state.zoomed_since.copy()
    for cell in shape_cells:
        centers, sizes = per_cell_boxes.get(
            int(cell), (np.zeros((0, 2)), np.zeros((0, 2))))
        new_zi = select_zoom(grid, cfg, state, int(cell), centers, sizes, dt)
        if new_zi > 0 and zi[cell] > 0:
            zs[cell] += dt
        elif new_zi > 0:
            zs[cell] = 0.0
        else:
            zs[cell] = 0.0
        zi[cell] = new_zi
    return ZoomState(zi, zs), zi
