"""Head/tail shape-search constants and the rectangular seed (paper §3.3),
numpy host side. The batched search itself is kernels/shape_search (its
plain loops and the shape_search kernel)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.grid import OrientationGrid


def best_rect(grid: OrientationGrid, size: int) -> tuple[int, int]:
    """Most-square (w, h) with w*h <= size on the grid lattice."""
    size = int(max(1, min(size, grid.n_cells)))
    best = (1, 1)
    for w in range(1, grid.n_pan + 1):
        for h in range(1, grid.n_tilt + 1):
            if w * h <= size and w * h > best[0] * best[1]:
                best = (w, h)
            elif (w * h == best[0] * best[1]
                  and abs(w - h) < abs(best[0] - best[1])):
                best = (w, h)
    return best


def seed_shape(grid: OrientationGrid, size: int,
               center_cell: int | None = None) -> np.ndarray:
    """Largest coverable rectangle of ~`size` cells around a center."""
    w, h = best_rect(grid, size)
    if center_cell is None:
        center_cell = grid.cell_index(grid.n_pan // 2, grid.n_tilt // 2)
    cp, ct = grid.cell_coords(center_cell)
    p0 = int(np.clip(cp - w // 2, 0, grid.n_pan - w))
    t0 = int(np.clip(ct - h // 2, 0, grid.n_tilt - h))
    mask = np.zeros(grid.n_cells, bool)
    for dp in range(w):
        for dt in range(h):
            mask[grid.cell_index(p0 + dp, t0 + dt)] = True
    return mask


@dataclass
class SearchConfig:
    base_threshold: float = 1.25   # H/T label ratio to justify a swap
    threshold_growth: float = 1.25  # per extra neighbor for the same H
    max_swaps: int = 8             # safety bound per timestep
